"""The design of the fused schedule step's CUDA kernel (kernel 7,
csrc/fused_schedule.cu), held on the CPU by a numpy model of it against
the plain version (`fused_stream_step_plain`), since the kernel itself
runs only on the card:

* the queue's prefix sum: tiles that take tickets from a counter that
  only grows, publish 64-bit status words tagged with the launch's
  number and look back over them 32 at a time, interleaved in random
  order over 32 consecutive launches on one never-cleared scratch, give
  exactly the exclusive cumsum of the retired lanes, and the last tile's
  totals give head', segments' and the live count;
* the lanes' fates: the plain step changes a field only on lanes whose
  fate names it, and reads a payload field only where the lane's fate
  needs it, so the kernel's fate-predicated payload loads lose nothing
  and a field a lane's fate leaves alone keeps its old value when the
  kernel rewrites it whole; the model, tiles and all, equals the plain
  step bit for bit (both rr_modes, a head that sends lanes past n_pix);
* the tiles: 256 lanes, one lane a thread, cover every lane of every
  pool the fused schedule allows, once, with no empty tile, in fewer
  tiles than a status word can count lanes."""

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
WINDOW = 32  # predecessors one warp reads at once


def word(tag, flag, done, live):
    return (tag << TAG_SHIFT) | flag | (int(done) << DONE_SHIFT) | int(live)


class Scratch:
    """The kernel's scratch: the ticket counter and a status word a tile,
    never cleared between launches."""

    def __init__(self, tiles):
        self.tiles = tiles
        self.ticket = 0
        self.words = [0] * tiles


def launch(scratch, done, live, rs):
    """One launch over tiles with per-tile counts `done` and `live`, the
    tiles' steps interleaved at random: take a ticket (in start order),
    publish the aggregate (tile 0: the inclusive prefix), look back a
    window of 32 words at a time, blocked while any word of the window is
    not yet this launch's, then publish the inclusive prefix.  Returns
    (retired lanes before each tile, the last tile's inclusive done and
    live)."""
    t = scratch.tiles
    before = np.full(t, -1, np.int64)
    agents = []  # per started tile: [tile, tag, phase, base, excl_done, excl_live]
    while len(agents) < t or any(a[2] != "done" for a in agents):
        runnable = [a for a in agents if a[2] != "done"]
        if len(agents) < t and (not runnable or rs.rand() < 0.3):
            ticket = scratch.ticket
            scratch.ticket += 1
            tile, tag = ticket % t, (ticket // t) % TAGS + 1
            agents.append([tile, tag, "publish", tile - 1, 0, 0])
            continue
        a = runnable[rs.randint(len(runnable))]
        tile, tag, phase, base = a[:4]
        if phase == "publish":
            flag = INCLUSIVE if tile == 0 else AGGREGATE
            scratch.words[tile] = word(tag, flag, done[tile], live[tile])
            a[2] = "done" if tile == 0 else "look"
            if tile == 0:
                before[0] = 0
            continue
        words = []
        for lane in range(WINDOW):
            q = base - lane
            w = word(tag, INCLUSIVE, 0, 0) if q < 0 else scratch.words[q]
            if w >> TAG_SHIFT != tag:
                break  # a predecessor of this launch has not published: the warp spins
            words.append(w)
        if len(words) < WINDOW:
            continue
        inclusive = [bool(w & INCLUSIVE) for w in words]
        stop = inclusive.index(True) if any(inclusive) else WINDOW - 1
        a[4] += sum((w >> DONE_SHIFT) & COUNT for w in words[: stop + 1])
        a[5] += sum(w & COUNT for w in words[: stop + 1])
        if any(inclusive):
            before[tile] = a[4]
            scratch.words[tile] = word(tag, INCLUSIVE, a[4] + done[tile], a[5] + live[tile])
            a[2] = "done"
        else:
            a[3] = base - WINDOW
    last = scratch.words[t - 1]
    return before, (last >> DONE_SHIFT) & COUNT, last & COUNT


@pytest.mark.parametrize("tiles", [1, 5, 77])
def test_look_back_equals_cumsum_over_consecutive_launches(tiles):
    """32 launches on one scratch, tiles interleaved at random: every
    tile's prefix is the exclusive cumsum, and the last tile holds the
    totals.  A word left by the previous launch is never taken as this
    launch's."""
    rs = np.random.RandomState(tiles)
    scratch = Scratch(tiles)
    for _ in range(32):
        done = rs.randint(0, 1025, tiles)
        live = done + rs.randint(0, 1025, tiles)
        before, total_done, total_live = launch(scratch, done, live, rs)
        np.testing.assert_array_equal(before, np.cumsum(done) - done)
        assert (total_done, total_live) == (done.sum(), live.sum())
    assert scratch.ticket == 32 * tiles


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


def model_step(tb, st, out, head, segments, *, spp, n_pix, max_depth, rr_reference, inv_spp):
    """The kernel's step in numpy: each lane's fate, then every field with
    its fate's new value and its old one elsewhere, on copies of the
    state; new slots from the tiles' look-back (tile counts, then lanes
    within a tile); the totals from the last tile.  Returns (state, image,
    regen, head', segments', live', the fates)."""
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
    scratch = Scratch(tiles)
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
