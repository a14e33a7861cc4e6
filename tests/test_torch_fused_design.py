"""The design of the fused schedule step's CUDA kernel (kernel 7,
csrc/fused_schedule.cu), held on the CPU by a numpy model of it against
the plain version (`fused_stream_step_plain`), since the kernel itself
runs only on the card:

* the queue's prefix sum: tiles that take tickets from a counter that
  only grows, publish 64-bit status words tagged with the launch's
  number and look back over them 32 at a time, interleaved in random
  order over 32 consecutive launches on one never-cleared scratch, give
  exactly the exclusive cumsum of the retired lanes, and the last tile's
  totals give head', segments' and the live count; in both layouts (one
  word a tile below 2^25 lanes, two from there: retired lanes, live
  lanes, each with its own tag and flag and its own look-back), the wide
  one up to 2^31 - 1 lanes (the last tiles of grids of up to 2^23 tiles),
  and on the scratches the wrapper keys by layout;
* the lanes' fates: the plain step changes a field only on lanes whose
  fate names it, and reads a payload field only where the lane's fate
  needs it, so the kernel's fate-predicated payload loads lose nothing
  and a field a lane's fate leaves alone keeps its old value when the
  kernel rewrites it whole; the model, tiles and all, equals the plain
  step bit for bit (both rr_modes, a head that sends lanes past n_pix);
* the tiles: 256 lanes, one lane a thread, cover every lane of every
  pool the fused schedule allows, once, with no empty tile, in fewer
  tiles than a status word can count lanes."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops import fused_schedule as fs  # noqa: E402
from tpu_pathtracer_torch.render.integrator import _fused_stream_ok  # noqa: E402

# A status word: tag << 52 | flag | retired lanes << 25 | live lanes.
TAG_SHIFT, TAGS, DONE_SHIFT = 52, 4095, 25
AGGREGATE, INCLUSIVE, COUNT = 1 << 50, 2 << 50, (1 << 25) - 1
# The wide layout (from NARROW_LANES lanes): two words a tile, each
# tag << 52 | flag | one count (retired lanes, then live lanes).
WIDE_COUNT = AGGREGATE - 1
NARROW_LANES = 2**25  # kNarrowLanes
MAX_LANES = 2**31 - 1  # cuda_build.MAX_LANES: the most lanes the wrapper takes
STATUS = 3  # kStatus: the ticket, the grid sum's arrivals and sum, then the status words
WINDOW = 32  # predecessors one warp reads at once


def word(tag, flag, done, live):
    return (tag << TAG_SHIFT) | flag | (int(done) << DONE_SHIFT) | int(live)


def wide_word(tag, flag, count):
    return (tag << TAG_SHIFT) | flag | int(count)


class Scratch:
    """The kernel's scratch: the ticket counter, then the status words
    (one a tile, or two in the wide layout), never cleared between
    launches; a word never written is 0, a fresh word."""

    def __init__(self, tiles, wide=False):
        self.tiles, self.wide, self.ticket, self.words = tiles, wide, 0, {}

    def read(self, index):
        return self.words.get(index, 0)

    def write(self, index, w):
        self.words[index] = w

    def publication(self, tile, tag, flag, done, live):
        """The atomic exchanges that publish a tile's counts: one word, or
        in the wide layout two, the retired lanes' first."""
        if self.wide:
            return [(2 * tile, wide_word(tag, flag, done)), (2 * tile + 1, wide_word(tag, flag, live))]
        return [(tile, word(tag, flag, done, live))]

    def totals(self, tile):
        """The inclusive retired and live lanes in `tile`'s words."""
        if self.wide:
            return self.read(2 * tile) & WIDE_COUNT, self.read(2 * tile + 1) & WIDE_COUNT
        w = self.read(tile)
        return (w >> DONE_SHIFT) & COUNT, w & COUNT


class Block:
    """One block's share of a launch: its tile and tag, its counts, the
    exchanges it has yet to make, where its look-back stands, the retired
    and live lanes of earlier tiles so far, and whether each count's
    look-back goes on (the narrow layout's two end together)."""

    def __init__(self, scratch, tile, tag, done, live):
        self.tile, self.tag, self.done, self.live = tile, tag, int(done), int(live)
        self.writes = scratch.publication(tile, tag, INCLUSIVE if tile == 0 else AGGREGATE, done, live)
        self.base, self.excl, self.open = tile - 1, [0, 0], [tile > 0, tile > 0]

    @property
    def finished(self):
        return not self.writes and not any(self.open)


def look(scratch, b):
    """One window of b's look-back: the warp reads the 32 nearest words
    not yet summed (both words a tile in the wide layout; a count whose
    look-back has ended, and a tile before 0, read as an inclusive prefix
    of nothing) and spins while any is not this launch's; else each count
    is summed up to its own nearest inclusive word, and its look-back ends
    there.  When both have ended, b's inclusive publication is queued."""
    nothing = wide_word(b.tag, INCLUSIVE, 0) if scratch.wide else word(b.tag, INCLUSIVE, 0, 0)
    window = []
    for lane in range(WINDOW):
        q = b.base - lane
        if scratch.wide:
            ws = [scratch.read(2 * q + k) if q >= 0 and b.open[k] else nothing for k in (0, 1)]
        else:
            ws = [scratch.read(q) if q >= 0 else nothing] * 2
        if any(w >> TAG_SHIFT != b.tag for w in ws):
            return  # a predecessor of this launch has not published: the warp spins
        window.append(ws)
    for k in (0, 1):
        if not b.open[k]:
            continue
        ws = [w[k] for w in window]
        inclusive = [bool(w & INCLUSIVE) for w in ws]
        stop = inclusive.index(True) if any(inclusive) else WINDOW - 1
        if scratch.wide:
            b.excl[k] += sum(w & WIDE_COUNT for w in ws[: stop + 1])
        else:
            b.excl[k] += sum((w >> DONE_SHIFT) & COUNT if k == 0 else w & COUNT for w in ws[: stop + 1])
        b.open[k] = not any(inclusive)
    if any(b.open):
        b.base -= WINDOW
    else:
        b.writes = scratch.publication(b.tile, b.tag, INCLUSIVE, b.excl[0] + b.done, b.excl[1] + b.live)


def launch(scratch, done, live, rs, ahead=0, each=(0, 0)):
    """One launch over tiles with per-tile counts `done` and `live`, the
    blocks' steps interleaved at random: take a ticket (in start order),
    publish the aggregate (tile 0: the inclusive prefix), one exchange a
    step, look back a window of 32 tiles at a time, blocked while any
    word of the window is not yet this launch's, then publish the
    inclusive prefix.  With `ahead`, the grid's first `ahead` tiles (each
    with counts `each`) took the first tickets and ran to their end
    before the others started: only the words of their last 32 are
    written, the only ones a later tile's look-back reads, so that a grid
    of 2^23 tiles is stepped through its last tiles alone.  Returns
    (retired lanes before each of the other tiles, the last tile's
    inclusive retired and live lanes)."""
    t = scratch.tiles
    assert ahead + len(done) == t and scratch.ticket % t == 0
    tag = (scratch.ticket // t) % TAGS + 1
    for q in range(max(0, ahead - WINDOW), ahead):
        for index, w in scratch.publication(q, tag, INCLUSIVE, (q + 1) * each[0], (q + 1) * each[1]):
            scratch.write(index, w)
    scratch.ticket += ahead
    before = np.full(len(done), -1, np.int64)
    blocks = []
    while len(blocks) < len(done) or not all(b.finished for b in blocks):
        runnable = [b for b in blocks if not b.finished]
        if len(blocks) < len(done) and (not runnable or rs.rand() < 0.3):
            ticket = scratch.ticket
            scratch.ticket += 1
            tile = ticket % t
            assert (ticket // t) % TAGS + 1 == tag
            blocks.append(Block(scratch, tile, tag, done[tile - ahead], live[tile - ahead]))
            continue
        b = runnable[rs.randint(len(runnable))]
        if b.writes:
            scratch.write(*b.writes.pop(0))
        else:
            look(scratch, b)
            if not any(b.open):
                before[b.tile - ahead] = b.excl[0]
    for b in blocks:
        if b.tile == 0:
            before[0] = 0
    return (before, *scratch.totals(t - 1))


LAYOUTS = ["narrow", "wide"]


def consecutive_launches(tiles, layout):
    """32 launches on one scratch of `layout`, tiles interleaved at random,
    the launches' tags wrapping from 4,095 to 1 half-way: every tile's
    prefix is the exclusive cumsum, and the last tile holds the totals."""
    rs = np.random.RandomState(tiles + 1000 * (layout == "wide"))
    scratch = Scratch(tiles, wide=layout == "wide")
    scratch.ticket = (TAGS - 16) * tiles
    for _ in range(32):
        done = rs.randint(0, 1025, tiles)
        live = done + rs.randint(0, 1025, tiles)
        before, total_done, total_live = launch(scratch, done, live, rs)
        np.testing.assert_array_equal(before, np.cumsum(done) - done)
        assert (total_done, total_live) == (done.sum(), live.sum())
    assert scratch.ticket == (TAGS + 16) * tiles


@pytest.mark.parametrize("tiles", [1, 5, 77])
def test_look_back_equals_cumsum_over_consecutive_launches(tiles):
    """The narrow layout: 32 launches on one scratch (consecutive_launches).
    A word left by the previous launch is never taken as this launch's."""
    consecutive_launches(tiles, "narrow")


@pytest.mark.parametrize("tiles", [1, 5, 77])
def test_wide_look_back_equals_cumsum_over_consecutive_launches(tiles):
    """The wide layout: 32 launches on one scratch (consecutive_launches),
    where a reader may see one word of a tile this launch's and the other
    not yet, or one inclusive and the other an aggregate."""
    consecutive_launches(tiles, "wide")


def grid_counts(lanes, share, rs, k):
    """The counts of a grid of `lanes` lanes in tiles of 256 (the last tile
    holds what is left), every lane live: the first tiles' retired
    lanes `share` of 256 each (all but the last k tiles, which launch
    steps one by one), the last k tiles' at random at that share (every
    lane retired at 1.0).  Returns (tiles, ahead, each, done, live)."""
    tiles = -(-lanes // fs.TILE_LANES)
    live = np.full(k, fs.TILE_LANES, np.int64)
    live[-1] = lanes - (tiles - 1) * fs.TILE_LANES
    done = live if share == 1.0 else rs.binomial(live, share)
    return tiles, tiles - k, (int(round(share * fs.TILE_LANES)), fs.TILE_LANES), done, live


WIDE_GRIDS = [NARROW_LANES, NARROW_LANES + 1, 2**30 + 77, MAX_LANES]


@pytest.mark.parametrize("lanes", WIDE_GRIDS)
def test_wide_look_back_at_the_largest_grids(lanes):
    """The wide layout at 2^25 and 2^25 + 1 lanes (its first grids), 2^30
    + 77 and 2^31 - 1 (the most the wrapper takes: 2^23 tiles, the last
    one lane short): the last 70 tiles of each grid stepped at random
    after the rest, over three consecutive launches on one scratch with
    every lane retired, none and half: each tile's prefix is the exclusive
    cumsum of the retired lanes and the last tile holds the totals, up to
    2^31 - 1 retired and live lanes, so that a count carrying into the
    flag, the tag or the other count would show."""
    rs = np.random.RandomState(lanes % 1009)
    k = 70
    scratch = Scratch(-(-lanes // fs.TILE_LANES), wide=True)
    for share in (1.0, 0.0, 0.5):
        tiles, ahead, each, done, live = grid_counts(lanes, share, rs, k)
        before, total_done, total_live = launch(scratch, done, live, rs, ahead=ahead, each=each)
        np.testing.assert_array_equal(before, ahead * each[0] + np.cumsum(done) - done)
        assert (total_done, total_live) == (ahead * each[0] + done.sum(), lanes)
        if share == 1.0:
            assert total_done == lanes
    assert scratch.ticket == 3 * tiles


def test_narrow_word_would_carry_past_its_grid():
    """The narrow layout at 2^25 lanes, every lane live and retired:
    the tiles' inclusive counts reach 2^25 and carry out of their 25-bit
    fields (the live lanes into the retired lanes' field, the retired
    lanes into the flags), so the totals come out wrong: why the kernel
    takes the wide layout from there."""
    rs = np.random.RandomState(3)
    tiles, ahead, each, done, live = grid_counts(NARROW_LANES, 1.0, rs, 40)
    before, total_done, total_live = launch(Scratch(tiles), done, live, rs, ahead=ahead, each=each)
    np.testing.assert_array_equal(before, ahead * each[0] + np.cumsum(done) - done)  # the prefixes still fit
    assert (total_done, total_live) != (NARROW_LANES, NARROW_LANES)


@pytest.mark.parametrize("first", LAYOUTS)
def test_narrow_and_wide_launches_of_one_tile_count_on_the_wrappers_scratches(monkeypatch, first):
    """2^25 - 1 and 2^25 lanes take the same 131,072 tiles, one the narrow
    layout and the other the wide one.  The wrapper gives them two
    scratches (fs._scratch: keyed by layout, each the size the library
    gives, fused_step_scratch_words as the source computes it), and
    launches of the two alternated, each on a scratch of its own, stay
    exact; a narrow launch on a wide scratch would leave the wide words
    past its own holding the old launch's tag, which 4,095 launches later
    reads as live again."""
    text = (Path(fs.__file__).parent.parent / "csrc" / "fused_schedule.cu").read_text()
    assert "return entry == 0 ? kStatus + (n < kNarrowLanes ? 1 : 2) * tiles : 3;" in text

    class Library:
        @staticmethod
        def fused_step_scratch_words(entry, n):
            tiles = -(-n // fs.TILE_LANES)
            return STATUS + (1 if n < NARROW_LANES else 2) * tiles if entry == 0 else 3

    monkeypatch.setattr(fs.bounce_ops, "library", lambda name: Library)
    fs._zeroed_scratch.cache_clear()
    cpu = torch.device("cpu")
    lanes = {"narrow": NARROW_LANES - 1, "wide": NARROW_LANES}
    tensors = {k: fs._scratch(cpu, 0, n) for k, n in lanes.items()}
    fs._zeroed_scratch.cache_clear()
    assert tensors["narrow"] is not tensors["wide"]
    assert [t.shape[0] for t in tensors.values()] == [STATUS + 131_072, STATUS + 2 * 131_072]
    scratches = {k: Scratch(131_072, wide=k == "wide") for k in LAYOUTS}
    rs = np.random.RandomState(7 + (first == "wide"))
    order = LAYOUTS if first == "narrow" else LAYOUTS[::-1]
    for turn in range(6):
        layout = order[turn % 2]
        tiles, ahead, each, done, live = grid_counts(lanes[layout], rs.choice([0.0, 0.5, 1.0]), rs, 40)
        before, total_done, total_live = launch(scratches[layout], done, live, rs, ahead=ahead, each=each)
        np.testing.assert_array_equal(before, ahead * each[0] + np.cumsum(done) - done)
        assert (total_done, total_live) == (ahead * each[0] + done.sum(), lanes[layout])

    # One scratch for both: the wide launch's last tile's words (from word
    # 131,072 on, which no narrow launch writes) keep its tag, the tag of
    # the launch 4,095 after it.
    shared = Scratch(131_072, wide=True)
    tiles, ahead, each, done, live = grid_counts(NARROW_LANES, 0.5, rs, 40)
    launch(shared, done, live, rs, ahead=ahead, each=each)
    stale = shared.read(2 * (tiles - 1))
    shared.ticket += (TAGS - 1) * tiles  # 4,094 narrow launches
    assert stale >> TAG_SHIFT == (shared.ticket // tiles) % TAGS + 1


def test_status_word_layouts_mirror_the_source():
    """The model's status words are the kernel's: the tag, the flags and
    the narrow word's two 25-bit counts; the wide words' one 50-bit count,
    which holds 2^31 - 1; the tag's 12 bits above the flags and a count
    within 64 bits; the layout chosen by n at launch; the wrapper's
    limit the int32 lane count."""
    text = (Path(fs.__file__).parent.parent / "csrc" / "fused_schedule.cu").read_text()
    assert f"constexpr int kTagShift = {TAG_SHIFT};" in text
    assert f"constexpr unsigned long long kTags = {TAGS};" in text
    assert "kAggregate = 1ull << 50;" in text and "kInclusive = 2ull << 50;" in text
    assert f"constexpr int kDoneShift = {DONE_SHIFT};" in text and "kCountMask = (1ull << 25) - 1;" in text
    assert "kWideCountMask = kAggregate - 1;" in text and "constexpr int kNarrowLanes = 1 << 25;" in text
    assert "return (tag << kTagShift) | flag | static_cast<unsigned long long>(count);" in text
    assert "if (p->n < kNarrowLanes) {\n      fused_step_kernel<false><<<" in text
    assert "fused_step_kernel<true><<<" in text and "constexpr int kStatus = 3;" in text
    assert TAGS.bit_length() + TAG_SHIFT == 64 and INCLUSIVE | AGGREGATE < 1 << TAG_SHIFT
    assert MAX_LANES <= WIDE_COUNT and WIDE_COUNT & (INCLUSIVE | AGGREGATE) == 0
    assert NARROW_LANES - 1 <= COUNT and 2 * DONE_SHIFT <= 50
    assert fs.NARROW_LANES == NARROW_LANES and fs.STREAM_MAX_LANES == MAX_LANES


def lane_pool(lanes, seed, head_past=False):
    """A lane pool after a trace: distinct live slots, a tenth retired,
    attenuations with zeros, values above 1 and NaNs; the head near n_pix,
    or (head_past) so near that some retiring lanes get slots past it."""
    rs = np.random.RandomState(seed)
    n_pix = 4 * lanes
    head = n_pix - (lanes // 64 if head_past else lanes // 4)
    slot = rs.permutation(head)[:lanes].astype(np.int32)
    dead = rs.rand(lanes) < 0.1
    slot[dead] = n_pix + rs.randint(0, 3, dead.sum())
    pix = np.where(dead, rs.randint(0, n_pix, lanes), slot).astype(np.int32)

    def vec3(lo, hi):
        return rs.uniform(lo, hi, (lanes, 3)).astype(np.float32)

    att = vec3(0.0, 1.3)
    att[rs.rand(lanes) < 0.05] = 0.0
    att[rs.rand(lanes) < 0.01, 1] = np.nan
    tb = dict(origin=vec3(-5, 5), direction=vec3(-1, 1), attenuation=att, radiance=vec3(0, 4),
              seeds=rs.randint(0, 2**32, lanes).astype(np.int64), done=rs.rand(lanes) < 0.3)
    st = dict(origin=vec3(-5, 5), direction=vec3(-1, 1), attenuation=vec3(0, 1), radiance=vec3(0, 2),
              seeds=rs.randint(0, 2**32, lanes).astype(np.int64), slot=slot, pix=pix,
              sample_i=rs.randint(0, 3, lanes).astype(np.int32),
              depth=rs.randint(0, 5, lanes).astype(np.int32), lane_accum=vec3(0, 6))
    return tb, st, n_pix, head


def pcg_hash(x):
    with np.errstate(over="ignore"):
        s = x.astype(np.uint32) * np.uint32(747796405) + np.uint32(2891336453)
        w = ((s >> ((s >> np.uint32(28)) + np.uint32(4))) ^ s) * np.uint32(277803737)
    return (w >> np.uint32(22)) ^ w


def model_step(tb, st, out, head, segments, *, spp, n_pix, max_depth, rr_reference, inv_spp, wide=False):
    """The kernel's step in numpy: each lane's fate, then every field with
    its fate's new value and its old one elsewhere, on copies of the
    state; new slots from the tiles' look-back (tile counts, then lanes
    within a tile), in the narrow status word layout or (`wide`) the wide
    one; the totals from the last tile.  Returns (state, image, regen,
    head', segments', live', the fates)."""
    lanes = st["slot"].shape[0]
    f32 = np.float32
    slot = st["slot"]
    live = slot < n_pix
    seed_new = pcg_hash(tb["seeds"])
    u_rr = seed_new.astype(f32) * f32(2.3283064365386963e-10)
    a = tb["attenuation"].copy()
    p = np.maximum(np.maximum(a[:, 0], a[:, 1]), a[:, 2])  # NaN propagates, as max_nan
    with np.errstate(invalid="ignore"):
        rr_done = tb["done"] | (u_rr > p)
        p_safe = np.where(p > 0, p, f32(1))
    newly, adv = live & rr_done, live & ~rr_done
    if not rr_reference:
        a[adv] = a[adv] / np.minimum(p_safe[adv], f32(1))[:, None]
    si = st["sample_i"] + newly.astype(np.int32)
    done = newly & (si >= spp)

    new = {k: x.copy() for k, x in st.items()}
    image = out.copy()
    new["seeds"][live] = seed_new[live].astype(np.int64)
    for k, src in (("origin", tb["origin"]), ("direction", tb["direction"]), ("attenuation", a),
                   ("radiance", tb["radiance"])):
        new[k][adv] = src[adv]
    new["depth"][adv] = st["depth"][adv] - 1
    res = tb["radiance"] / p_safe[:, None] if rr_reference else tb["radiance"]
    acc = st["lane_accum"] + res
    image[slot[done]] = image[slot[done]] + acc[done] * f32(inv_spp)
    new["lane_accum"][newly] = np.where(done[:, None], f32(0), acc)[newly]
    new["sample_i"][newly] = np.where(done, 0, si)[newly]

    tiles = -(-lanes // fs.TILE_LANES)
    pad = tiles * fs.TILE_LANES - lanes
    per_lane = np.pad(done, (0, pad)).reshape(tiles, fs.TILE_LANES)
    tile_done = per_lane.sum(axis=1)
    scratch = Scratch(tiles, wide=wide)
    before_tile, total_done, total_live = launch(scratch, tile_done, np.pad(live, (0, pad)).reshape(tiles, -1).sum(1),
                                                 np.random.RandomState(lanes))
    before_lane = np.cumsum(per_lane, axis=1) - per_lane
    excl = (before_tile[:, None] + before_lane).reshape(-1)[:lanes]
    slot_new = (head + excl).astype(np.int32)
    live_next = np.where(done, slot_new < n_pix, True)
    regen = newly & live_next
    new["slot"][done] = slot_new[done]
    new["pix"][done] = slot_new[done]
    new["attenuation"][regen] = f32(1)
    new["radiance"][regen] = f32(0)
    new["depth"][regen] = max_depth
    room = n_pix - head
    live_after = total_live - total_done + min(max(room, 0), total_done)
    fates = dict(live=live, adv=adv, newly=newly, done=done, regen=regen)
    return new, image, regen, head + total_done, segments + total_live, live_after, fates


# field: the fates whose lanes the step may change it on
FIELDS = {
    "seeds": ("live",), "origin": ("adv",), "direction": ("adv",), "attenuation": ("adv", "regen"),
    "radiance": ("adv", "regen"), "depth": ("adv", "regen"), "lane_accum": ("newly",),
    "sample_i": ("newly",), "slot": ("done",), "pix": ("done",),
}


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind != "f":
        return np.array_equal(a, b)
    nan = np.isnan(a)
    return np.array_equal(nan, np.isnan(b)) and np.array_equal(np.where(nan, 0, a).view(np.int32),
                                                              np.where(nan, 0, b).view(np.int32))


@pytest.mark.parametrize("head_past", [False, True], ids=["head", "head_past_n_pix"])
@pytest.mark.parametrize("rr_mode", ["reference", "standard"])
@pytest.mark.parametrize("lanes", [128, 4096, 16384, 16512])
def test_model_step_equals_plain_step(lanes, rr_mode, head_past):
    """The plain step changes a field only on lanes whose fate names it,
    and the model, tiles and all, equals the plain step in every field,
    the image, the regen mask, head', segments' and the live count.  (A
    lane that does not end keeps its pixel sum: the plain step adds +0.0
    to it, which changes no sum that is not -0.0, and a sum starts at
    +0.0 and only ever adds.)"""
    tb, st, n_pix, head = lane_pool(lanes, lanes + (rr_mode == "standard") + 2 * head_past, head_past)
    kw = dict(spp=3, n_pix=n_pix, max_depth=4, rr_reference=rr_mode == "reference", inv_spp=1.0 / 3)
    out = np.random.RandomState(1).rand(n_pix + 1, 3).astype(np.float32)
    st_t = {k: torch.as_tensor(x.copy()) for k, x in st.items()}
    out_t = torch.as_tensor(out.copy())
    regen_t, head_t, seg_t, live_t = fs.fused_stream_step_plain(
        {k: torch.as_tensor(x) for k, x in tb.items()}, st_t, out_t, torch.tensor(head), torch.tensor(1000), **kw)
    new, image, regen, head_m, seg_m, live_m, fates = model_step(tb, st, out, head, 1000, **kw)
    for key, names in FIELDS.items():
        old, plain = st[key].reshape(lanes, -1), st_t[key].numpy().reshape(lanes, -1)
        if old.dtype == np.float32:
            old, plain = old.view(np.int32), plain.view(np.int32)
        changed = (old != plain).any(axis=1)
        allowed = np.any([fates[n] for n in names], axis=0)
        assert not (changed & ~allowed).any(), key
        assert same_bits(new[key], st_t[key].numpy()), key
    assert same_bits(image, out_t.numpy())
    assert np.array_equal(regen, regen_t.numpy())
    assert (head_m, seg_m, live_m) == (int(head_t), int(seg_t), int(live_t))
    assert fates["done"].any() and fates["adv"].any() and fates["regen"].any()
    if head_past:
        assert (head + fates["done"].sum() > n_pix) and not (regen == fates["newly"]).all()


@pytest.mark.parametrize("lanes", [128, 16512])
def test_model_step_in_the_wide_layout_equals_plain_step(lanes):
    """The model with the wide layout's two look-backs equals the plain
    step, as the narrow one does, in every field, the image, the regen
    mask, head', segments' and the live count."""
    tb, st, n_pix, head = lane_pool(lanes, 3 * lanes + 1, head_past=True)
    kw = dict(spp=3, n_pix=n_pix, max_depth=4, rr_reference=False, inv_spp=1.0 / 3)
    out = np.random.RandomState(2).rand(n_pix + 1, 3).astype(np.float32)
    st_t = {k: torch.as_tensor(x.copy()) for k, x in st.items()}
    out_t = torch.as_tensor(out.copy())
    regen_t, head_t, seg_t, live_t = fs.fused_stream_step_plain(
        {k: torch.as_tensor(x) for k, x in tb.items()}, st_t, out_t, torch.tensor(head), torch.tensor(7), **kw)
    new, image, regen, head_m, seg_m, live_m, fates = model_step(tb, st, out, head, 7, wide=True, **kw)
    for key in st:
        assert same_bits(new[key], st_t[key].numpy()), key
    assert same_bits(image, out_t.numpy()) and np.array_equal(regen, regen_t.numpy())
    assert (head_m, seg_m, live_m) == (int(head_t), int(seg_t), int(live_t)) and fates["done"].any()


def allowed_pools(limit):
    cfg = RenderConfig(fused_schedule="on")
    return [n for n in range(128, limit + 1, 128) if _fused_stream_ok(cfg, None, n, "cpu")]


@pytest.mark.parametrize("rr_mode", ["reference", "standard"])
def test_payload_loads_by_fate_lose_nothing(rr_mode):
    """The kernel reads the trace payload's seed, done flag, attenuation
    and radiance only on live lanes, and its origin and direction only on
    lanes that go on: the plain step on a payload poisoned everywhere else
    gives the same bits."""
    tb, st, n_pix, head = lane_pool(4096, 9 + (rr_mode == "standard"), head_past=True)
    kw = dict(spp=3, n_pix=n_pix, max_depth=4, rr_reference=rr_mode == "reference", inv_spp=1.0 / 3)
    *_, fates = model_step(tb, st, np.zeros((n_pix + 1, 3), np.float32), head, 0, **kw)
    poisoned = {k: x.copy() for k, x in tb.items()}
    rs = np.random.RandomState(2)
    for keys, need in ((("origin", "direction"), fates["adv"]),
                       (("attenuation", "radiance", "seeds", "done"), fates["live"])):
        for k in keys:
            junk = rs.randint(0, 2**32, poisoned[k].shape).astype(np.int64) if k == "seeds" else (
                rs.rand(*poisoned[k].shape) < 0.5 if k == "done" else np.float32(np.nan))
            poisoned[k][~need] = junk[~need] if isinstance(junk, np.ndarray) else junk
    results = []
    for payload in (tb, poisoned):
        state = {k: torch.as_tensor(x.copy()) for k, x in st.items()}
        image = torch.zeros((n_pix + 1, 3))
        got = fs.fused_stream_step_plain({k: torch.as_tensor(x) for k, x in payload.items()}, state, image,
                                         torch.tensor(head), torch.tensor(0), **kw)
        results.append((state, image, got))
    (st_a, img_a, got_a), (st_b, img_b, got_b) = results
    assert fates["live"].any() and not fates["live"].all() and fates["adv"].any()
    for k in st_a:
        assert same_bits(st_a[k].numpy(), st_b[k].numpy()), k
    assert same_bits(img_a.numpy(), img_b.numpy()) and torch.equal(got_a[0], got_b[0])
    assert [int(x) for x in got_a[1:]] == [int(x) for x in got_b[1:]]


def lanes_covered(lanes):
    """The lanes that tiles of TILE_LANES give their threads (thread x of
    tile t takes lane t*TILE_LANES + x), those inside the pool, in order;
    the tile count; and whether the last tile holds a lane."""
    tiles = -(-lanes // fs.TILE_LANES)
    taken = (np.arange(tiles)[:, None] * fs.TILE_LANES + np.arange(fs.TILE_LANES)[None, :]).reshape(-1)
    return taken[taken < lanes], tiles, (tiles - 1) * fs.TILE_LANES < lanes


def test_tiles_cover_every_lane_of_every_allowed_pool():
    """Every pool the fused schedule takes (whole 128-lane rows, the JAX
    envelope) up to 2^20 lanes: each lane taken once, in lane order (the
    queue's order), no tile empty, and the tiles' retired and live counts
    fit a status word's 25-bit fields."""
    pools = allowed_pools(1 << 20)
    assert 128 in pools and 16384 in pools and 131072 in pools and 524288 in pools
    assert 128 * 130 not in pools
    for lanes in pools:
        taken, tiles, no_empty_tile = lanes_covered(lanes)
        assert np.array_equal(taken, np.arange(lanes)) and no_empty_tile, lanes
        assert tiles * fs.TILE_LANES < 1 << DONE_SHIFT and lanes <= COUNT, lanes
