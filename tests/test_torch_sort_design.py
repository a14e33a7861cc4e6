"""The design of the ray sort's CUDA kernels (csrc/ray_sort.cu:
sort_cluster_kernel, sort_keys_kernel, sort_pass_kernel), held on the CPU
by a numpy model of them, since the kernels run only on the card:

* a warp ranks its keys an item at a time by a match of the lanes that
  share a digit (one ballot a bit) on a count a digit in shared memory,
  which gives each key the number of keys of its digit before it in
  index order;
* the digit passes: 8-bit digits over the key's width as the host
  derives it from the bit counts, 1 to 4 passes for every setting the
  config allows;
* up to 16,384 rays the sort is one launch, a cluster of a block a tile
  of 2,048 keys that sums the blocks' counts a digit over distributed
  shared memory each pass; above, over tiles of 256 threads x 4, 8 or 16
  keys (as ray_sort.tile_items picks by n), the keys launch counts
  every pass's digits and its last block (in whatever order the blocks
  arrive) turns the counts into the digit starts and sets them back to
  0, and each pass's tiles take tickets, find the earlier tiles' keys of
  each digit by a look-back over tagged status words, 16 words at a
  time, interleaved at random, on a scratch that is never cleared, past
  the wrap of the tags, and write each digit's keys from a tile staged in
  its sorted order;
* the status words are 32-bit up to 2^23 - 1 keys and 64-bit above: the
  wide word holds counts past 2^23 (tile counts synthesized, up to the
  2^31 - 1 rays an int32 index reaches) with no carry into its flags or
  tag, where the narrow word would carry, and runs past the tag wrap;
* the model's permutation equals np.argsort(kind="stable") and JAX's
  lax.sort_key_val permutation of the keys of ray_sort_key (the sort
  inside sort_by_key), with many ties: every key equal, two values, two
  thirds of the lanes parked (one key), at every size around a warp's, a
  tile's and the one-launch limit."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer_torch.ops import ray_sort  # noqa: E402

SOURCE = Path(ray_sort.__file__).resolve().parent.parent / "csrc" / "ray_sort.cu"
RADIX_BITS, RADIX, MAX_PASSES = 8, 256, 4
THREADS, ITEMS = 256, 8                     # the one-launch sort's tile: 256 threads, 8 keys a thread
TILE = THREADS * ITEMS
CLUSTER_MAX = 8                             # the one-launch sort: a cluster of up to 8 blocks, a tile each
SMALL_MAX = CLUSTER_MAX * TILE
TILE_ITEMS = (4, 8, 16)                     # keys a thread of the launches over tiles
WINDOW = 16                                 # earlier tiles' words a look-back step reads
PAD = 0xFFFFFFFF
TAG_BITS, TAGS = 7, 127
MAX_RAYS = 2**31 - 1                        # an int32 ray index


class Layout:
    """A status word of `bits` bits: tag << shift | flag | count, the tag in
    the top TAG_BITS bits, the two flags below it, the count below them."""

    def __init__(self, bits):
        self.dtype = {32: np.uint32, 64: np.uint64}[bits]
        self.shift = bits - TAG_BITS
        self.aggregate, self.inclusive = 1 << (self.shift - 2), 2 << (self.shift - 2)
        self.count = (1 << (self.shift - 2)) - 1


NARROW, WIDE = Layout(32), Layout(64)       # up to NARROW.count = 2^23 - 1 keys, and above
SIZES = [0, 1, 255, 256, 257, 16_383, 16_384, 16_385, 131_072]
ALL_BITS = [(s, d) for s in range(10) for d in range(5)]
SCENE_LO, SCENE_HI = torch.tensor([-4.0, 0.0, -2.0]), torch.tensor([4.0, 3.0, 2.0])


def test_constants_match_the_cuda_source():
    """The model's and the wrapper's sizes are the kernel's."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr [\w ]+ {name} = ([0-9]+)", src).group(1))

    assert const("kRadixBits") == RADIX_BITS == ray_sort.RADIX_BITS
    assert const("kMaxPasses") == MAX_PASSES
    assert (const("kThreads"), const("kItems")) == (THREADS, ITEMS) == (ray_sort.TILE_THREADS, 8)
    assert ray_sort.TILE_ITEMS == TILE_ITEMS
    assert all(f"launch_tiles<{k}>(a, s)" in src for k in TILE_ITEMS)
    assert {ray_sort.tile_items(n) for n in (16_385, 131_072, 345_600, 1 << 20, (1 << 20) + 1, ray_sort.MAX_RAYS)} \
        <= set(TILE_ITEMS)
    assert (const("kClusterMax"), const("kWindow")) == (CLUSTER_MAX, WINDOW)
    assert ray_sort.SMALL_MAX == SMALL_MAX
    assert (const("kTagBits"), const("kTags")) == (TAG_BITS, TAGS)
    # the status word's fields below its tag, and the word by n
    assert "kTagShift = 8 * static_cast<int>(sizeof(Word)) - kTagBits;" in src
    assert "kAggregate = Word{1} << (kTagShift - 2);" in src and "kInclusive = Word{2} << (kTagShift - 2);" in src
    assert "kCountMask = (Word{1} << (kTagShift - 2)) - 1;" in src
    assert "using NarrowWord = unsigned;" in src and "using WideWord = unsigned long long;" in src
    assert "kNarrowMax = static_cast<int>(Status<NarrowWord>::kCountMask);" in src
    assert "a.n > kNarrowMax ? launch_passes<Items, WideWord>(a, s) : launch_passes<Items, NarrowWord>(a, s)" in src
    assert NARROW.count == ray_sort.NARROW_MAX == 2**23 - 1 and WIDE.count >= MAX_RAYS == ray_sort.MAX_RAYS
    assert (NARROW.shift, WIDE.shift) == (25, 57)
    # the scratch: ticket, arrival, then the counts and starts of every pass
    assert ray_sort.STATUS_OFFSET == 2 + 2 * MAX_PASSES * RADIX
    assert "kStatus = kStarts + kMaxPasses * kRadix" in src and "kStarts = kCounts + kMaxPasses * kRadix" in src


# ---------------------------------------------------------------------------
# The warp's ranks
# ---------------------------------------------------------------------------

def match_digit(row):
    """The kernel's match_digit over a warp's 32 digits: for each lane, the
    AND over the digit's bits of the ballot of lanes with that bit set (or
    its complement where the lane's bit is clear).  [32] bool masks."""
    peers = np.ones((32, 32), bool)
    for b in range(RADIX_BITS):
        bit = (row >> b) & 1 == 1
        peers &= np.where(bit[:, None], bit[None, :], ~bit[None, :])
    return peers


@pytest.mark.parametrize("ties", ["spread", "two", "equal"])
def test_match_digit_is_equal_digits(ties):
    """One ballot a bit finds exactly the lanes with the same 8-bit digit."""
    rs = np.random.RandomState(len(ties))
    high = dict(spread=RADIX, two=2, equal=1)[ties]
    for _ in range(50):
        row = rs.randint(0, high, 32) * (RADIX // high)
        np.testing.assert_array_equal(match_digit(row), row[:, None] == row[None, :])


def match_any_ranks(digits, counts):
    """The kernel's warp_rank over a warp's keys, [items, 32] digits, item
    by item: each lane's rank is its digit's count plus the lanes below it
    with the same digit (match_digit), and the lowest of them adds the
    group to the count.  Returns [items, 32] ranks; `counts` advances."""
    ranks = np.zeros(digits.shape, np.int64)
    for j, row in enumerate(digits):
        before = counts.copy()  # every peer reads the count before the leader writes it
        match = match_digit(row)
        for lane in range(32):
            peers = match[lane]
            ranks[j, lane] = before[row[lane]] + int(peers[:lane].sum())
            if not peers[:lane].any():
                counts[row[lane]] = before[row[lane]] + int(peers.sum())
    return ranks


def cumcount(rows):
    """Each entry's count of equal entries before it in its row."""
    m = rows.shape[1]
    order = np.argsort(rows, axis=1, kind="stable")
    sorted_ = np.take_along_axis(rows, order, 1)
    pos = np.broadcast_to(np.arange(m), rows.shape)
    first = np.maximum.accumulate(np.where(np.diff(sorted_, axis=1, prepend=-1) != 0, pos, 0), axis=1)
    out = np.empty_like(rows)
    np.put_along_axis(out, order, pos - first, 1)
    return out


@pytest.mark.parametrize("items", [1, *TILE_ITEMS])
@pytest.mark.parametrize("ties", ["spread", "two", "equal"])
def test_match_any_ranks_count_in_index_order(ties, items):
    """A warp's match_any ranks over its items (key first + 32 j for item
    j of lane l) are, for each key, the keys of its digit before it in
    index order, and its counts end as the digits' histogram."""
    rs = np.random.RandomState(items)
    high = dict(spread=RADIX, two=2, equal=1)[ties]
    digits = rs.randint(0, high, (items, 32)) * (RADIX // high)
    counts = np.zeros(RADIX, np.int64)
    ranks = match_any_ranks(digits, counts)
    np.testing.assert_array_equal(ranks.reshape(-1), cumcount(digits.reshape(1, -1))[0])
    np.testing.assert_array_equal(counts, np.bincount(digits.reshape(-1), minlength=RADIX))


# ---------------------------------------------------------------------------
# The passes over the key's width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spatial_bits", range(10))
def test_digit_passes_cover_the_key(spatial_bits):
    """For every direction-bit setting: the passes of 8-bit digits cover
    the key's width, which is what the largest key needs, with no pass to
    spare, and at most 4 (5 launches above one block, 1 up to it)."""
    o, d = SCENE_HI[None, :] + 1.0, torch.ones((1, 3))
    for dir_bits in range(5):
        width = ray_sort.key_width(spatial_bits, dir_bits)
        passes = ray_sort.digit_passes(spatial_bits, dir_bits)
        top = int(ray_sort.sort_key_plain(o, d, SCENE_LO, SCENE_HI, spatial_bits, dir_bits)[0])
        assert top == (1 << width) - 1 and width <= 30
        assert RADIX_BITS * (passes - 1) < width <= RADIX_BITS * passes and 1 <= passes <= MAX_PASSES
        assert ray_sort.sort_launches(SMALL_MAX, spatial_bits, dir_bits) == 1
        assert ray_sort.sort_launches(SMALL_MAX + 1, spatial_bits, dir_bits) == 1 + passes <= 5
        assert ray_sort.sort_launches(0, spatial_bits, dir_bits) == 0


# ---------------------------------------------------------------------------
# The model of the kernels
# ---------------------------------------------------------------------------

class Scratch:
    """The sort's scratch, zeroed once and never again: the pass
    launches' ticket counter, the keys launch's arrival counter, every
    pass's digit counts and starts, a status word of `layout` a tile a
    digit; for launches over `tiles` tiles of `tile` keys."""

    def __init__(self, tiles, tile=TILE, layout=NARROW):
        self.tiles, self.tile, self.layout = tiles, tile, layout
        self.ticket = 0
        self.arrival = 0
        self.counts = np.zeros((MAX_PASSES, RADIX), np.int64)
        self.starts = np.zeros((MAX_PASSES, RADIX), np.int64)
        self.words = np.zeros((tiles, RADIX), layout.dtype)


def word(layout, tag, flag, count):
    """The status words tag << shift | flag | count, cut to the word's bits
    as the kernel's casts cut them (a count past its field carries into
    the flags and the tag)."""
    t = layout.dtype
    return (t(tag) << t(layout.shift)) | t(flag) | (np.asarray(count).astype(np.uint64) & t(~t(0))).astype(t)


def keys_launch(scratch, keys, passes, rs):
    """sort_keys_kernel: each block adds its tile's counts of every pass's
    digits into the scratch and takes an arrival number, in random order;
    the block that arrives last of the launch writes each pass's digit
    starts (an exclusive scan) and sets the counts back to 0."""
    t = scratch.tiles
    for tile in rs.permutation(t):
        part = keys[tile * scratch.tile:(tile + 1) * scratch.tile]
        for p in range(passes):
            scratch.counts[p] += np.bincount((part >> (RADIX_BITS * p)) & (RADIX - 1), minlength=RADIX)
        arrival = scratch.arrival
        scratch.arrival += 1
        if arrival % t == t - 1:
            for p in range(passes):
                scratch.starts[p] = np.cumsum(scratch.counts[p]) - scratch.counts[p]
                scratch.counts[p] = 0


def look_back(scratch, totals, rs, max_steps=None):
    """The tiles of one pass launch, interleaved at random: take a ticket
    (in start order; tile and tag from it), publish the tile's counts a
    digit (tile 0: inclusive), then, a thread a digit, read the earlier
    tiles' words of the digit WINDOW at a time, nearest first, adding each
    of this launch's words up to the first inclusive one, and reading
    again from the first word not yet this launch's; then publish the
    inclusive count.  Returns [tiles, digits]: the keys of each digit in
    earlier tiles.  `max_steps`: raise after that many steps (a look-back
    that can never end)."""
    t = scratch.tiles
    before = np.full((t, RADIX), -1, np.int64)
    agents = []  # started tiles: dict(tile, tag, phase, q, acc, open)
    digit = np.arange(RADIX)
    lay = scratch.layout
    steps = 0
    while len(agents) < t or any(a["phase"] != "done" for a in agents):
        steps += 1
        if max_steps is not None and steps > max_steps:
            raise AssertionError(f"the look-back did not end in {max_steps} steps")
        runnable = [a for a in agents if a["phase"] != "done"]
        if len(agents) < t and (not runnable or rs.rand() < 0.3):
            ticket = scratch.ticket
            scratch.ticket += 1
            agents.append(dict(tile=ticket % t, tag=(ticket // t) % TAGS + 1, phase="publish"))
            continue
        a = runnable[rs.randint(len(runnable))]
        tile, tag = a["tile"], a["tag"]
        if a["phase"] == "publish":
            if tile == 0:
                scratch.words[0] = word(lay, tag, lay.inclusive, totals[0])
                before[0] = 0
                a["phase"] = "done"
            else:
                scratch.words[tile] = word(lay, tag, lay.aggregate, totals[tile])
                a.update(phase="look", q=np.full(RADIX, tile - 1), acc=np.zeros(RADIX, np.int64),
                         open=np.ones(RADIX, bool))
            continue
        # one step of every digit still looking: its window, read at once
        window = np.stack([np.where(a["q"] - k >= 0, scratch.words[np.maximum(a["q"] - k, 0), digit],
                                    word(lay, tag, lay.inclusive, np.zeros(RADIX, np.int64))) for k in range(WINDOW)])
        going, taken = a["open"].copy(), np.zeros(RADIX, np.int64)
        for w in window:
            going &= (w >> lay.dtype(lay.shift)) == tag
            a["acc"][going] += (w[going] & lay.dtype(lay.count)).astype(np.int64)
            taken += going
            inclusive = going & ((w & lay.dtype(lay.inclusive)) != 0)
            a["open"] &= ~inclusive
            going &= ~inclusive
        a["q"] -= np.where(a["open"], taken, 0)
        if not a["open"].any():
            before[tile] = a["acc"]
            scratch.words[tile] = word(lay, tag, lay.inclusive, a["acc"] + totals[tile])
            a["phase"] = "done"
    return before


def tile_ranks(digits, warp_keys):
    """A tile's ranks as the kernel's warps make them: digits [tiles, T]
    in index order, cut into warps of `warp_keys` consecutive keys.
    Returns (each key's offset within its tile's keys of its digit: the
    earlier warps' keys of the digit plus its rank in its warp, and the
    tile's count a digit [tiles, digits])."""
    tiles, t = digits.shape
    warps = t // warp_keys
    rows = digits.reshape(tiles * warps, warp_keys)
    rank = cumcount(rows)
    counts = np.zeros((tiles * warps, RADIX), np.int64)
    np.add.at(counts, (np.repeat(np.arange(tiles * warps), warp_keys), rows.reshape(-1)), 1)
    counts = counts.reshape(tiles, warps, RADIX)
    offsets = np.cumsum(counts, axis=1) - counts  # earlier warps' keys of each digit
    w = np.repeat(np.arange(warps), warp_keys)
    within = offsets[np.arange(tiles)[:, None], w[None, :], digits] + rank.reshape(tiles, t)
    return within, counts.sum(axis=1)


def model_sort(keys, passes, scratch=None, rs=None):
    """The kernels' sort of the int keys: perm (int64).  Up to SMALL_MAX
    keys one cluster of tiles of TILE keys (sort_cluster_kernel: each
    block's digit starts and earlier tiles' keys from every block's counts
    a digit); above, over `scratch`'s tiles (sort_keys_kernel, then a
    sort_pass_kernel a pass: the look-back, the tile staged in its sorted
    order, each staged key written at its digit's start plus its place in
    the digit's run)."""
    n = keys.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    small = n <= SMALL_MAX
    tile_keys = TILE if small else scratch.tile
    tiles = -(-n // tile_keys)
    assert not small or tiles <= CLUSTER_MAX
    pad = np.full(tiles * tile_keys - n, PAD, np.int64)
    cur_keys, cur_idx = keys.astype(np.int64), np.arange(n)
    if not small:
        assert scratch.tiles == tiles
        keys_launch(scratch, cur_keys, passes, rs)
    tile_of = np.arange(tiles)[:, None]
    for p in range(passes):
        padded = np.concatenate([cur_keys, pad])
        digits = ((padded >> (RADIX_BITS * p)) & (RADIX - 1)).reshape(tiles, tile_keys)
        within, totals = tile_ranks(digits, 32 * tile_keys // THREADS)
        if small:
            # every block reads every block's counts: all of them a digit, and the earlier blocks'
            every = totals.sum(axis=0)
            before = np.cumsum(totals, axis=0) - totals
            pos = (np.cumsum(every) - every)[digits] + before[tile_of, digits] + within
        else:
            before = look_back(scratch, totals, rs)
            np.testing.assert_array_equal(before, np.cumsum(totals, axis=0) - totals)
            start = scratch.starts[p][None, :] + before          # [tiles, digits], the whole order
            local = np.cumsum(totals, axis=1) - totals            # [tiles, digits], the tile's
            stage = local[tile_of, digits] + within               # each key's slot in its tile's stage
            valid = (np.arange(tiles * tile_keys) < n).reshape(tiles, tile_keys)
            tile_idx = np.broadcast_to(tile_of, (tiles, tile_keys))
            keys_here = np.minimum(tile_keys, n - np.arange(tiles) * tile_keys)
            assert (stage < keys_here[:, None])[valid].all()  # the pads' slots stay past the tile's keys
            # the write step: slot t holds the key staged there, whose row is start + t - local of its digit
            staged = np.zeros((tiles, tile_keys), np.int64)
            staged[tile_idx[valid], stage[valid]] = digits[valid]
            slot_row = start[tile_of, staged] + np.arange(tile_keys) - local[tile_of, staged]
            pos = np.zeros((tiles, tile_keys), np.int64)
            pos[valid] = slot_row[tile_idx[valid], stage[valid]]
        pos = pos.reshape(-1)[:n]
        assert sorted(pos.tolist()) == list(range(n))
        nxt_keys, nxt_idx = np.empty_like(cur_keys), np.empty_like(cur_idx)
        nxt_keys[pos], nxt_idx[pos] = cur_keys, cur_idx
        cur_keys, cur_idx = nxt_keys, nxt_idx
    if not small:
        assert not scratch.counts.any()  # the keys launch's last block set them back to 0
    return cur_idx


def tie_rays(ties, n, seed):
    """Rays and a mask: spread (random rays), equal (one ray n times), two
    (two rays, at random), parked (random rays, two thirds parked by the
    mask: one key)."""
    rs = np.random.RandomState(seed)
    o = (rs.randn(n, 3) * np.array([5.0, 2.0, 5.0]) + np.array([0.0, 1.5, 0.0])).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    if ties == "equal" and n:
        o[:], d[:] = o[0], d[0]
    elif ties == "two" and n:
        pick = rs.rand(n) < 0.5
        o[pick], d[pick] = o[0], d[0]
        o[~pick], d[~pick] = o[-1], -d[0]
    active = rs.rand(n) >= 2 / 3 if ties == "parked" else None
    return torch.as_tensor(o), torch.as_tensor(d), None if active is None else torch.as_tensor(active)


def jax_perm(keys):
    """lax.sort_key_val's permutation of the u32 keys (sort_by_key's sort)."""
    n = keys.shape[0]
    _, perm = jax.lax.sort_key_val(jnp.asarray(keys.astype(np.uint32)), jnp.arange(n, dtype=jnp.int32))
    return np.asarray(perm)


@pytest.mark.parametrize("ties", ["spread", "equal", "two", "parked"])
@pytest.mark.parametrize("n", SIZES)
def test_model_sort_equals_stable_argsort_and_jax(n, ties):
    """The model's permutation of ray_sort_key's keys (the plain key, with
    the mask's parking) equals np.argsort(kind="stable") and JAX's
    lax.sort_key_val permutation, and the plain sort's (torch.sort
    stable), at every allowed bit setting up to 16,385 rays and at each
    pass count's settings at 131,072; one scratch serves every sort of a
    size, so later sorts run on words and counters earlier ones left."""
    o, d, active = tie_rays(ties, n, seed=n + len(ties))
    settings = ALL_BITS if n <= 16_385 else [(0, 0), (0, 2), (0, 4), (5, 2), (7, 2), (5, 3), (9, 4)]
    rs = np.random.RandomState(n)
    tile = THREADS * ray_sort.tile_items(n)
    assert not ray_sort.wide_status(n)
    scratch = Scratch(-(-n // tile), tile) if n > SMALL_MAX else None
    for bits in settings:
        keys = ray_sort.sort_key_plain(o, d, SCENE_LO, SCENE_HI, *bits, active).numpy()
        perm = model_sort(keys, ray_sort.digit_passes(*bits), scratch, rs)
        want = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(perm, want, err_msg=str(bits))
        np.testing.assert_array_equal(perm, jax_perm(keys), err_msg=str(bits))
        if bits in ((0, 2), (7, 2)):
            got = ray_sort.sort_rays_plain(o, d, SCENE_LO, SCENE_HI, *bits, active)[2].numpy()
            np.testing.assert_array_equal(perm, got, err_msg=str(bits))
    if ties == "equal" and n:
        assert len(np.unique(keys)) == 1
    if ties == "parked" and n > 256:
        assert (keys == np.bincount(keys).argmax()).mean() > 0.6  # the parked lanes' one key


@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("tiles", [1, 2, 3, 17])
def test_look_back_past_the_tag_wrap(tiles, layout):
    """300 pass launches on one never-cleared scratch (past the 127 tags
    twice: a launch's tag repeats that of the launch 127 before it), the
    tiles of each interleaved at random: every tile's earlier keys of
    each digit are the exclusive cumsum over tiles, and a word left by the
    previous launch is never taken as this launch's; with 32-bit words,
    and with 64-bit words whose tiles' counts (synthesized, as a batch of
    up to 2^31 - 1 rays makes them) run past 2^23."""
    rs = np.random.RandomState(tiles)
    scratch = Scratch(tiles, layout=dict(narrow=NARROW, wide=WIDE)[layout])
    top = TILE // 64 if layout == "narrow" else MAX_RAYS // (RADIX * 17)
    for launch in range(300):
        totals = rs.randint(0, top, (tiles, RADIX)) * (rs.rand(tiles, RADIX) < 0.3)
        before = look_back(scratch, totals, rs)
        np.testing.assert_array_equal(before, np.cumsum(totals, axis=0) - totals, err_msg=str(launch))
    assert scratch.ticket == 300 * tiles and (scratch.ticket // tiles - 1) % TAGS + 1 == 300 - 2 * TAGS


@pytest.mark.parametrize("items", TILE_ITEMS)
@pytest.mark.parametrize("n", [16_385, 40_000])
def test_consecutive_sorts_share_one_scratch(n, items):
    """16 sorts of different keys and pass counts on one scratch (the
    closest-hit and the shadow sort of 8 iterations), over tiles of 256 x
    `items` keys, the blocks of each launch in random order: each equals
    the stable argsort, and the digit counts are back to 0 after each."""
    rs = np.random.RandomState(n)
    tile = THREADS * items
    scratch = Scratch(-(-n // tile), tile)
    for k in range(16):
        bits = ALL_BITS[rs.randint(len(ALL_BITS))]
        o, d, active = tie_rays(["spread", "parked"][k % 2], n, seed=k)
        keys = ray_sort.sort_key_plain(o, d, SCENE_LO, SCENE_HI, *bits, active).numpy()
        perm = model_sort(keys, ray_sort.digit_passes(*bits), scratch, rs)
        np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"), err_msg=f"sort {k} {bits}")


# ---------------------------------------------------------------------------
# The status word's width: 32 bits up to 2^23 - 1 keys, 64 above
# ---------------------------------------------------------------------------

def big_totals(tiles, rs):
    """[tiles, digits] tile counts a digit of MAX_RAYS keys in all, in
    four digits, so that a tile's count of a digit and the running sums
    pass 2^23 - 1: as a sort of 2^31 - 1 rays would publish them, without
    the rays."""
    totals = np.zeros((tiles, RADIX), np.int64)
    digits = rs.choice(RADIX, 4, replace=False)
    share = rs.dirichlet(np.full(tiles * 4, 20.0)) * MAX_RAYS
    totals[:, digits] = np.floor(share).astype(np.int64).reshape(tiles, 4)
    totals[-1, digits[0]] += MAX_RAYS - totals.sum()
    assert totals.sum() == MAX_RAYS and (totals >= 0).all() and totals.max() > NARROW.count
    return totals


@pytest.mark.parametrize("tiles", [2, 5, 17])
def test_wide_words_count_past_the_narrow_field(tiles):
    """A pass launch whose tiles' counts a digit run past 2^23 - 1 (up to
    2^31 - 1 keys in all), the tiles interleaved at random: with 64-bit
    status words every tile's earlier keys of each digit are the exclusive
    cumsum, each inclusive word's count its field exactly, its tag and
    flag intact; with 32-bit words the counts carry into the flags and the
    tag, and the look-back does not give the cumsum."""
    rs = np.random.RandomState(tiles)
    totals = big_totals(tiles, rs)
    want = np.cumsum(totals, axis=0) - totals
    assert want.max() > NARROW.count
    wide = Scratch(tiles, layout=WIDE)
    np.testing.assert_array_equal(look_back(wide, totals, rs), want)
    w = wide.words
    assert ((w >> np.uint64(WIDE.shift)) == 1).all() and ((w & np.uint64(3 << (WIDE.shift - 2))) ==
                                                           np.uint64(WIDE.inclusive)).all()
    np.testing.assert_array_equal((w & np.uint64(WIDE.count)).astype(np.int64), want + totals)
    narrow = Scratch(tiles, layout=NARROW)
    try:
        got = look_back(narrow, totals, np.random.RandomState(tiles), max_steps=100 * tiles)
    except AssertionError:
        return  # a carried flag or tag can leave a digit looking forever or past tile 0
    assert not np.array_equal(got, want)


@pytest.mark.parametrize("ties", ["spread", "parked"])
@pytest.mark.parametrize("n", [16_385, 40_000, 131_072])
def test_model_sort_with_wide_words_equals_stable_argsort_and_jax(n, ties):
    """The sort over tiles with 64-bit status words (which the card takes
    above 2^23 - 1 rays; here forced at smaller n, the rays real): its
    permutation equals np.argsort(kind="stable"), JAX's lax.sort_key_val
    and the plain sort's, on one scratch over every pass count."""
    o, d, active = tie_rays(ties, n, seed=n + 5)
    rs = np.random.RandomState(n + 1)
    tile = THREADS * ray_sort.tile_items(n)
    scratch = Scratch(-(-n // tile), tile, layout=WIDE)
    for bits in [(0, 0), (0, 4), (5, 2), (9, 4)]:
        keys = ray_sort.sort_key_plain(o, d, SCENE_LO, SCENE_HI, *bits, active).numpy()
        perm = model_sort(keys, ray_sort.digit_passes(*bits), scratch, rs)
        np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"), err_msg=str(bits))
        np.testing.assert_array_equal(perm, jax_perm(keys), err_msg=str(bits))
        got = ray_sort.sort_rays_plain(o, d, SCENE_LO, SCENE_HI, *bits, active)[2].numpy()
        np.testing.assert_array_equal(perm, got, err_msg=str(bits))


def test_status_word_width_by_n_and_scratch_by_width():
    """The wrapper takes 64-bit words exactly above 2^23 - 1 rays, as the
    kernel does; n = 2^23 - 1 and 2^23 take the same 2,048 tiles of 4,096
    keys, so each width has a scratch of its own, of room for a 64-bit
    word a tile a digit; a tile's last index (n rounded up to whole tiles)
    stays below 2^31 up to MAX_RAYS."""
    assert not ray_sort.wide_status(NARROW.count) and ray_sort.wide_status(NARROW.count + 1)
    tiles = {n: -(-n // (THREADS * ray_sort.tile_items(n))) for n in (NARROW.count, NARROW.count + 1)}
    assert set(tiles.values()) == {2048}
    narrow, wide = (ray_sort._scratch(torch.device("cpu"), 2048, w) for w in (False, True))
    assert narrow.data_ptr() != wide.data_ptr()
    assert narrow.shape == wide.shape == (ray_sort.STATUS_OFFSET + 2048 * RADIX,)
    for n in (NARROW.count + 1, 35_251_200, MAX_RAYS):
        tile = THREADS * ray_sort.tile_items(n)
        assert -(-n // tile) * tile - 1 <= MAX_RAYS and 3 * MAX_RAYS > 2**31  # 64-bit row products
