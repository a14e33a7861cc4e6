"""The design of the path step (csrc/fused_schedule.cu: path_step_kernel,
the step of render_rays and render_pixels_regen), on the CPU.

* A numpy model of the kernel equals `path_step_plain` bit for bit, at 0
  to 4,096 lanes with none, a third, 97% and all of the lanes ended at
  entry, in both schedules, both rr_modes, and without NEE, with NEE's
  bool env credit and with its float32 (MIS) one, and over 32 steps of a
  loop on one scratch.  The model keeps the kernel's order: the loads
  before the wait (the flag, and a live lane's depth, sample_i and
  accum) and after it (the payload), the stores each lane's fate needs,
  and the totals through the blocks' packed arrivals, read by the block
  that arrives last, the blocks in any order.  Every access is logged: an
  ended lane loads its flag and nothing else and stores nothing; a live
  lane stores origin and direction only if it goes on, attenuation,
  radiance, depth and the env credit only if it goes on or respawns;
  nothing of the payload is loaded and nothing is stored before the wait;
  the fields the model loads before the wait are the ones the kernel's
  source reads there.
* The totals need no memset (`packed_sum`, the model's count word, held
  over 32 launches beside the stream step's grid sum in
  tests/test_torch_schedule_steps.py).
* `path_step_plain` leaves every field of an ended lane as it was, bit
  for bit, on the states the loop reaches (24 steps from a fresh state,
  the payload's radiance with -0.0 in it), and never makes accum -0.0:
  the kernel may skip those lanes.
* The sources: the path step waits once, reads no payload field and
  stores nothing before it; the bounce kernel and the NEE kernel let
  their dependent start at entry; the wrapper refuses a dependent launch
  whose payload a copy would make; the integrator asks for a dependent
  path step exactly where the trace's last launch is the bounce or the
  NEE kernel.

The kernel against path_step_plain on the card, alone and behind its
predecessors: tests/test_torch_cuda.py -k path_step.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tpu_pathtracer_torch.ops import cuda_build  # noqa: E402
from tpu_pathtracer_torch.ops import fused_schedule as fs  # noqa: E402
from tpu_pathtracer_torch.render import integrator  # noqa: E402

CSRC = Path(__file__).resolve().parent.parent / "tpu_pathtracer_torch" / "csrc"
WAIT = "launch_order::wait_for_launch_before();"
TRIGGER = "launch_order::let_dependents_start();"
# A store to memory: an element of a StepParams array (or of one cast)
# or a pointee assigned, an atomic, the grid sum.
STORE = re.compile(r"\bp\.\w+\s*\[[^\]]*\]\s*=(?!=)|\(p\.\w+\)\s*\[[^\]]*\]\s*=(?!=)|\*\s*p\.\w+\s*=(?!=)"
                   r"|\batomic\w*\s*\(|\bgrid_sum\b")
THREADS = 256  # a block's lanes (kThreads)
WARP = 32
SPP, MAX_DEPTH = 3, 4
NEE_MODES = ("off", "bool", "f32")
LANES = (0, 1, 300, 4096)
SHARES = (0.0, 1 / 3, 0.97, 1.0)
MASK32 = 0xFFFFFFFF
INV_U32 = np.float32(2.0**-32)


def code(source: str) -> str:
    """csrc/`source` without its comments."""
    return re.sub(r"//[^\n]*", "", (CSRC / source).read_text())


def body(source: str, name: str) -> str:
    """The body of the function `name` (its first definition) in
    csrc/`source`, comments removed."""
    text = code(source)
    m = re.search(r"\b%s\s*\(" % name, text)
    depth, start = 0, text.index("{", text.index(")", m.end()))
    for k in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[k], 0)
        if depth == 0:
            return text[start + 1 : k]
    raise AssertionError(f"{name}: unbalanced braces")


def fields_read(text: str) -> set:
    """The StepParams fields that a stretch of the kernel reads (p.x
    indexed, or cast and indexed)."""
    return set(re.findall(r"\bp\.(\w+)\s*\[", text)) | set(re.findall(r"\(p\.(\w+)\)\s*\[", text))


# ---------------------------------------------------------------------------
# The numpy model of the kernel
# ---------------------------------------------------------------------------

class Memory:
    """The kernel's global memory by StepParams field (numpy arrays), each
    access logged as (phase, field, "load" or "store", the lanes)."""

    def __init__(self, arrays: dict):
        self.arrays = arrays
        self.log = []

    def load(self, phase, field, lanes):
        self.log.append((phase, field, "load", lanes.copy()))
        return self.arrays[field]

    def store(self, phase, field, lanes, value):
        self.log.append((phase, field, "store", lanes.copy()))
        self.arrays[field][lanes] = value[lanes]


def pcg(x):
    """One PCG-RXS-M-XS round on u32 values (uint64 arithmetic)."""
    state = (x.astype(np.uint64) * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def max_nan(a, b):
    """The kernel's max_nan: a where a is NaN or above b, else b."""
    return np.where(np.isnan(a) | (a > b), a, b)


OPEN_SHIFT, ARRIVAL_SHIFT = 25, 43  # the kernel's kOpenShift, kArrivalShift
TILE_BITS = ARRIVAL_SHIFT - OPEN_SHIFT  # the tiles-not-ended field, and the arrivals
NARROW_LANES = 2**25  # kNarrowLanes: from here on the wide layout
WIDE_ARRIVAL_SHIFT = 32  # kWideArrivalShift: live lanes below, arrivals above
U64 = np.uint64


def packed_sum(scratch, counts, rs, wide=False):
    """The path step's totals over the blocks' counts ([tiles, 3]: live,
    hit, not ended) on `scratch` ([the count word, the hit sum, the tiles
    not ended], zeroed once; the narrow layout uses the first two): each
    block adds its hit lanes into the hit sum (wide: and 1 into the tiles
    not ended if it has such a lane), then, after its fence, adds its live
    lanes, whether it has a lane not ended (narrow) and one arrival into
    the count word in one atomic; the block whose add finds T - 1 arrivals
    reads the totals (its add's result and its own, and the other words)
    and sets them all to 0.  The blocks arrive in a random order; a
    block's adds before its arrival are all in by the last one's.  The
    count word in 64-bit arithmetic, as the card's: a field that
    overflows carries into the next, and the word wraps.  Returns (live
    lanes, hit lanes, tiles with a lane not ended), or None where no
    block read the totals."""
    tiles = counts.shape[0]
    shift = WIDE_ARRIVAL_SHIFT if wide else ARRIVAL_SHIFT
    open_ = counts[:, 2] != 0
    mine = counts[:, 0].astype(U64) | U64(1 << shift)
    if not wide:
        mine |= open_.astype(U64) << U64(OPEN_SHIFT)
    order = rs.permutation(tiles)  # the blocks by arrival
    mine = mine[order]
    word_after = np.cumsum(mine, dtype=U64) + U64(int(scratch[0]) % 2**64)  # wraps as the card's word
    word_before = word_after - mine
    last = np.flatnonzero(word_before >> U64(shift) == U64(tiles - 1))
    assert last.size <= 1, "two blocks took themselves for the last"
    scratch[1] += int(counts[:, 1].sum())
    if wide:
        scratch[2] += int(open_.sum())
    if not last.size:
        return None
    word = int(word_after[last[0]])
    if wide:
        total = np.array([word & (1 << shift) - 1, scratch[1], scratch[2]])
    else:
        total = np.array([word & (1 << OPEN_SHIFT) - 1, scratch[1], word >> OPEN_SHIFT & (1 << TILE_BITS) - 1])
    if last[0] == tiles - 1:  # the last block's read: it sets every word back to 0
        scratch[:] = 0
    return total


def kernel_model(mem: Memory, n, schedule, nee, rr_reference, scratch, rs):
    """path_step_kernel over n lanes on `mem`, in its order: before the
    wait the flag and a live lane's depth (regen: sample_i, accum); after
    it the payload of the live lanes; the roulette and merges; the stores
    each live lane's fate needs; the blocks' packed arrivals and, by the
    block that arrives last, the totals.  No launch at n = 0 (the wrapper sets
    `done`)."""
    regen_schedule = schedule == "regen"
    if n == 0:
        mem.arrays["done"][...] = True
        return
    tiles = -(-n // THREADS)
    pad = tiles * THREADS
    in_ = np.arange(pad) < n

    def lanes(x, fill=0):
        """x over the padded grid (out-of-range lanes read nothing)."""
        out = np.full((pad,) + x.shape[1:], fill, dtype=x.dtype)
        out[:n] = x
        return out

    # ---- before the wait -------------------------------------------------
    live = in_ & (lanes(mem.load("before", "flag", in_[:n])) == 0)
    own = {k: lanes(mem.load("before", k, live[:n])) for k in ("depth",) + (("sample_i", "accum") if regen_schedule
                                                                              else ())}

    # ---- after it: the payload, one round ----------------------------------
    pay = {k: lanes(mem.load("after", f"tb_{k}", live[:n])) for k in ("seeds", "done", "attenuation", "radiance",
                                                                       "origin", "direction")}
    if nee != "off":
        pay.update({k: lanes(mem.load("after", f"tb_{k}", live[:n])) for k in ("hit", "spec")})

    seed = pcg(pay["seeds"].astype(np.uint64) & MASK32)
    u = seed.astype(np.uint32).astype(np.float32) * INV_U32
    a = pay["attenuation"]
    p = max_nan(max_nan(a[:, 0], a[:, 1]), a[:, 2])
    p_safe = np.where(p > 0, p, np.float32(1))
    adv = live & ~(pay["done"] | (u > p))
    newly = live & ~adv
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        if rr_reference:
            res = pay["radiance"] / p_safe[:, None]
            a_on = a
        else:
            res = pay["radiance"]
            a_on = a / np.minimum(p_safe, np.float32(1))[:, None]
    mem.store("after", "seeds", live[:n], seed.astype(np.int64)[:n])
    if regen_schedule:
        si = own["sample_i"] + newly.astype(np.int32)
        ended = ~live | (newly & (si >= SPP))
        regen = newly & ~ended
        acc = own["accum"] + np.where(newly[:, None], res, np.float32(0))
        for k, v in (("accum", acc), ("sample_i", si), ("regen", regen)):
            mem.store("after", k, live[:n], v[:n])
    else:
        ended = ~live | newly
        regen = np.zeros(pad, dtype=bool)
        mem.store("after", "result", newly[:n], res[:n])
    mem.store("after", "flag", live[:n], ended[:n])
    moved = adv | regen
    rg = regen[:, None]
    mem.store("after", "origin", adv[:n], pay["origin"][:n])
    mem.store("after", "direction", adv[:n], pay["direction"][:n])
    mem.store("after", "attenuation", moved[:n], np.where(rg, np.float32(1), a_on)[:n])
    mem.store("after", "radiance", moved[:n], np.where(rg, np.float32(0), pay["radiance"])[:n])
    mem.store("after", "depth", moved[:n], np.where(regen, np.int32(MAX_DEPTH), own["depth"] - 1)[:n])
    if nee != "off":
        mem.store("after", "spec", moved[:n], np.where(regen, np.ones_like(pay["spec"]), pay["spec"])[:n])

    # ---- the counts, and the totals by the block that arrives last ----------
    hit = live & pay["hit"] if nee != "off" else np.zeros(pad, dtype=bool)
    counts = np.stack([m.reshape(tiles, THREADS).sum(axis=1) for m in (live, hit, ~ended)], axis=1)
    total = packed_sum(scratch, counts, rs, wide=n >= NARROW_LANES)
    mem.arrays["segments"][...] += total[0]
    if nee != "off":
        mem.arrays["shadow"][...] += total[1]
    mem.arrays["done"][...] = total[2] == 0


# ---------------------------------------------------------------------------
# States, seeded with numpy
# ---------------------------------------------------------------------------

def make_state(n, share, schedule, nee, seed):
    """A loop's buffers and a trace payload over n lanes, round(share * n)
    of them ended at entry, as numpy arrays by path_step_plain's keys (st)
    and `_trace_bounce`'s (tb).  Reachable as the kernel relies on: no
    -0.0 in an ended lane's accum (a live lane's may hold one, which the
    step makes +0.0), an ended lane's byte of the regen buffer 0.  The
    payload's attenuations hold zeros, values above 1 and NaNs, its
    radiances a -0.0 or two."""
    rs = np.random.RandomState(seed)
    ended = np.zeros(n, dtype=bool)
    ended[rs.permutation(n)[: int(round(share * n))]] = True

    def vec3(lo, hi):
        return rs.uniform(lo, hi, (n, 3)).astype(np.float32)

    att = vec3(0.0, 1.3)
    att[rs.rand(n) < 0.05] = 0.0
    att[rs.rand(n) < 0.02, 1] = np.nan
    rad = vec3(0.0, 4.0)
    rad[rs.rand(n) < 0.02] = -0.0
    tb = dict(origin=vec3(-5, 5), direction=vec3(-1, 1), attenuation=att, radiance=rad,
              seeds=rs.randint(0, 2**32, n).astype(np.int64), done=rs.rand(n) < 0.3)
    st = dict(origin=vec3(-5, 5), direction=vec3(-1, 1), attenuation=vec3(0, 1), radiance=vec3(0, 2),
              seeds=rs.randint(0, 2**32, n).astype(np.int64), depth=rs.randint(0, 5, n).astype(np.int32),
              done=np.zeros((), dtype=bool), segments=np.array(1000, dtype=np.int64),
              shadow=np.array(50, dtype=np.int64))
    if schedule == "rays":
        st.update(terminated=ended, result=vec3(0, 3))
    else:
        accum = vec3(0, 6)
        accum[rs.rand(n) < 0.05] = 0.0
        accum[(rs.rand(n) < 0.05) & ~ended] = -0.0
        st.update(exhausted=ended, sample_i=rs.randint(0, SPP, n).astype(np.int32), accum=accum,
                  regen=(rs.rand(n) < 0.5) & ~ended)
    if nee != "off":
        spec = (lambda: rs.uniform(0, 1, n).astype(np.float32)) if nee == "f32" else (lambda: rs.rand(n) < 0.5)
        tb.update(hit=rs.rand(n) < 0.7, spec_last=spec())
        st["spec_last"] = spec()
    return tb, st


FLAG = {"rays": "terminated", "regen": "exhausted"}
# StepParams fields by path_step_plain's keys
FIELD = dict(spec_last="spec", terminated="flag", exhausted="flag")


def model_step(tb, st, schedule, nee, rr_reference, scratch, rs):
    """kernel_model on copies of the numpy buffers: (the buffers after
    it by path_step_plain's keys, the access log)."""
    arrays = {FIELD.get(k, k): np.array(v, copy=True) for k, v in st.items()}
    arrays.update({f"tb_{FIELD.get(k, k)}": np.array(v, copy=True) for k, v in tb.items()})
    mem = Memory(arrays)
    kernel_model(mem, st["seeds"].shape[0], schedule, nee, rr_reference, scratch, rs)
    return {k: mem.arrays[FIELD.get(k, k)] for k in st}, mem.log


def plain_step(tb, st, schedule, nee, rr_reference):
    """path_step_plain on torch copies: the buffers after it as numpy."""
    tb_t = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in tb.items()}
    st_t = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in st.items()}
    fs.path_step_plain(tb_t, st_t, schedule=schedule, spp=SPP, max_depth=MAX_DEPTH, rr_reference=rr_reference,
                       nee=nee != "off")
    return {k: v.numpy() for k, v in st_t.items()}


def bits(x):
    """x's bit patterns, every NaN one pattern (the card writes its own)."""
    x = np.asarray(x)
    if x.dtype == np.float32:
        return np.where(np.isnan(x), np.float32(np.nan), x).view(np.int32)
    return x


def assert_same(got, want, what=""):
    for k in want:
        assert np.array_equal(bits(got[k]), bits(want[k])), (what, k)


# ---------------------------------------------------------------------------
# The model against path_step_plain
# ---------------------------------------------------------------------------

def scratch_for(n):
    """A path step's scratch, zeroed once: the count word, the hit sum
    and the tiles not ended (csrc/fused_schedule.cu:
    fused_step_scratch_words)."""
    return np.zeros(3, dtype=np.int64)


@pytest.mark.parametrize("nee", NEE_MODES)
@pytest.mark.parametrize("rr_mode", ["reference", "standard"])
@pytest.mark.parametrize("schedule", ["rays", "regen"])
@pytest.mark.parametrize("share", SHARES, ids=["none", "third", "97pct", "all"])
@pytest.mark.parametrize("lanes", LANES)
def test_model_equals_plain(lanes, share, schedule, rr_mode, nee):
    """The kernel's model equals path_step_plain on every buffer, the
    counters and `done` included; an ended lane loads its flag and nothing
    else and stores nothing; a live lane stores origin and direction only
    if it goes on, attenuation, radiance, depth and the env credit only if
    it goes on or respawns; nothing of the payload is loaded and nothing
    stored before the wait, and nothing but the payload after it."""
    seed = lanes + 13 * SHARES.index(share) + 101 * NEE_MODES.index(nee) + 7 * (schedule == "regen")
    tb, st = make_state(lanes, share, schedule, nee, seed)
    rr_reference = rr_mode == "reference"
    got, log = model_step(tb, st, schedule, nee, rr_reference, scratch_for(lanes), np.random.RandomState(seed))
    assert_same(got, plain_step(tb, st, schedule, nee, rr_reference), (lanes, share))

    ended = st[FLAG[schedule]]
    # the live lanes' fates, as path_step_plain's roulette draws them
    _, _, adv, _, _ = fs.roulette({k: torch.from_numpy(v) for k, v in tb.items()}, torch.from_numpy(~ended),
                                  rr_mode == "reference")
    adv = adv.numpy()
    for phase, field, op, touched in log:
        if field == "flag" and op == "load":
            assert phase == "before"
            continue
        assert not (touched & ended).any(), (phase, field, op)
        if phase == "before":
            assert op == "load" and not field.startswith("tb_"), (field, op)
        elif op == "load":
            assert field.startswith("tb_"), field
        elif field in ("origin", "direction"):
            assert np.array_equal(touched, adv), field
        elif field in ("attenuation", "radiance", "depth", "spec"):
            assert not (touched & ~adv & ~got.get("regen", np.zeros_like(adv))).any(), field


@pytest.mark.parametrize("nee", NEE_MODES)
@pytest.mark.parametrize("schedule", ["rays", "regen"])
def test_model_equals_plain_over_32_steps(schedule, nee):
    """32 steps of a loop on one scratch, zeroed once, from a fresh state
    (every lane live, accum +0.0, the regen buffer 0), a new payload each
    step and the last eight ending every path: the model and
    path_step_plain stay bit-equal, the count words clear themselves, and
    `done` turns true."""
    n, rs = 1000, np.random.RandomState(5 + NEE_MODES.index(nee))
    tb, st = make_state(n, 0.0, schedule, nee, 1)
    if schedule == "regen":
        st.update(accum=np.zeros((n, 3), dtype=np.float32), sample_i=np.zeros(n, dtype=np.int32),
                  regen=np.zeros(n, dtype=bool))
    scratch = scratch_for(n)
    for step in range(32):
        tb = make_state(n, 0.0, schedule, nee, 100 + step)[0]
        if step >= 24:
            tb["done"][:] = True
        got, _ = model_step(tb, st, schedule, nee, False, scratch, rs)
        want = plain_step(tb, st, schedule, nee, False)
        assert_same(got, want, step)
        assert (scratch == 0).all()
        st = want
    assert bool(st["done"]) and st[FLAG[schedule]].all()


def test_model_reads_before_the_wait_what_the_kernel_reads():
    """The fields the model loads before its wait are the ones the
    kernel's source reads before its wait, and its payload loads after it
    are the kernel's."""
    tb, st = make_state(600, 1 / 3, "regen", "f32", 3)
    _, log = model_step(tb, st, "regen", "f32", False, scratch_for(600), np.random.RandomState(0))
    pre, _, post = body("fused_schedule.cu", "path_step_kernel").partition(WAIT)
    assert {f for phase, f, op, _ in log if phase == "before"} == fields_read(pre)
    loaded = {f for phase, f, op, _ in log if phase == "after" and op == "load"}
    assert loaded == {f for f in fields_read(post) if f.startswith("tb_")}


MAX_LANES = 2**31 - 1  # the most lanes the path step's wrapper takes (fs._path_lanes)
GRIDS = [(MAX_LANES, "every"), (MAX_LANES, "the last"), (MAX_LANES, "none"),
         (NARROW_LANES - 1, "every"), (NARROW_LANES, "every"), (NARROW_LANES + 1, "every")]


@pytest.mark.parametrize("lanes,open_tiles", GRIDS, ids=[f"{n}-{o.replace(' ', '_')}" for n, o in GRIDS])
def test_count_word_holds_the_largest_grid(lanes, open_tiles):
    """At the most lanes the wrapper takes (2^31 - 1: 2^23 tiles, the last
    one lane short), every lane live and hit, and every tile, the last or
    none with a lane not ended; and at the largest grid of the narrow
    layout (2^25 - 1 lanes, 2^17 tiles) and the two smallest of the wide
    one (2^25 and 2^25 + 1): the count word's fields do not carry into
    each other, the last block to arrive reads exactly the launch's
    totals, and every word is 0 after it."""
    tiles = -(-lanes // THREADS)
    assert fs._path_lanes({"seeds": torch.zeros(1).expand(lanes)}) == lanes
    counts = np.full((tiles, 3), THREADS, dtype=np.int16)
    counts[-1, :2] = lanes - (tiles - 1) * THREADS
    counts[:, 2] = {"every": 1, "the last": np.arange(tiles) == tiles - 1, "none": 0}[open_tiles]
    scratch = scratch_for(lanes)
    total = packed_sum(scratch, counts, np.random.RandomState(17), wide=lanes >= NARROW_LANES)
    assert total is not None and total[0] == total[1] == lanes
    assert total[2] == (counts[:, 2] > 0).sum() and (scratch == 0).all()


def test_narrow_word_would_carry_past_its_grid():
    """The narrow layout at 2^25 lanes (every lane live, every tile open)
    carries its live count into the tiles-not-ended field: why the kernel
    takes the wide layout from there."""
    tiles = NARROW_LANES // THREADS
    counts = np.full((tiles, 3), THREADS, dtype=np.int16)
    total = packed_sum(scratch_for(NARROW_LANES), counts, np.random.RandomState(5))
    assert total is None or total[0] != NARROW_LANES or total[2] != tiles


def test_count_word_layout_mirrors_the_source():
    """The model's count words are the kernel's: below 2^25 lanes the live
    lanes' field, then the tiles-not-ended field, then the arrivals; from
    2^25 on live lanes and arrivals, the tiles not ended in a word of
    their own; each field wide enough for the most lanes its layout
    takes, the word's 64 bits not exceeded; the wrappers' limits and the
    scratch's size the kernel's (the path step's three words at every
    lane count)."""
    text = code("fused_schedule.cu")
    shifts = re.search(r"kOpenShift = (\d+), kArrivalShift = (\d+);", text)
    assert tuple(map(int, shifts.groups())) == (OPEN_SHIFT, ARRIVAL_SHIFT)
    assert re.search(r"kTileMask = \(1ull << %d\) - 1;" % TILE_BITS, text)
    assert "constexpr int kNarrowLanes = 1 << 25;" in text and NARROW_LANES == fs.NARROW_LANES
    assert f"constexpr int kWideArrivalShift = {WIDE_ARRIVAL_SHIFT};" in text
    assert "kWideLiveMask = (1ull << kWideArrivalShift) - 1;" in text
    assert "p->n < kNarrowLanes" in text and "? kStatus + (n < kNarrowLanes ? 1 : 2) * tiles : 3;" in text
    narrow_tiles = -(-(NARROW_LANES - 1) // THREADS)
    assert NARROW_LANES - 1 < 1 << OPEN_SHIFT and narrow_tiles < 1 << TILE_BITS
    assert ARRIVAL_SHIFT + narrow_tiles.bit_length() <= 64
    wide_tiles = -(-MAX_LANES // THREADS)
    assert MAX_LANES < 1 << WIDE_ARRIVAL_SHIFT and WIDE_ARRIVAL_SHIFT + wide_tiles.bit_length() <= 64
    assert cuda_build.MAX_LANES == MAX_LANES == fs.STREAM_MAX_LANES


@pytest.mark.parametrize("lanes", [NARROW_LANES - 1, NARROW_LANES, 35_251_200, MAX_LANES])
def test_path_step_wrapper_takes_every_grid_an_int32_index_reaches(lanes):
    """path_step_cuda takes 2^25 lanes and more (1080p at 17 spp without
    regeneration, 35,251,200) up to 2^31 - 1, stopping only at its check
    that the buffers lie on a CUDA device; one lane more is refused,
    naming the int32 index."""
    st = {"seeds": torch.zeros(1, dtype=torch.int64).expand(lanes)}
    kw = dict(schedule="rays", spp=1, max_depth=4, rr_reference=False, nee=False)
    with pytest.raises(ValueError, match="CUDA"):
        fs.path_step_cuda({}, st, **kw)
    with pytest.raises(ValueError, match=r"path step's lanes: .*int32: at most 2147483647 \(2\^31 - 1\)"):
        fs.path_step_cuda({}, {"seeds": torch.zeros(1, dtype=torch.int64).expand(MAX_LANES + 1)}, **kw)


def test_kernel_int_fields_refuse_more_than_int32():
    """Every argument struct's int field (lanes, slots, sizes) takes up to
    2^31 - 1 and refuses more, naming the field, where ctypes would cut the
    value silently (ops/bounce._params, which the shading kernels and the
    steps share)."""
    from tpu_pathtracer_torch.ops import bounce as bounce_ops

    assert bounce_ops._params(fs.StepParams, {}, {"n": MAX_LANES}, None).n == MAX_LANES
    with pytest.raises(ValueError, match=r"StepParams\.n: .*int32: at most 2147483647"):
        bounce_ops._params(fs.StepParams, {}, {"n": MAX_LANES + 1}, None)


def test_stream_step_keeps_its_refusal_at_2_25_lanes():
    """Kernel 7 (the stream step) no longer refuses 2^25 lanes: its tiles
    publish two status words each from there (csrc/fused_schedule.cu:
    kNarrowLanes).  Its wrapper takes 2^25 - 1, 2^25 and 2^25 + 1 lanes
    and 2^31 - 1 (stopping at the CUDA check), and refuses one lane more
    with a message naming the stream step's int32 lanes; its launcher
    still refuses a dependent launch, and no longer a lane count."""
    kw = dict(spp=1, n_pix=1, max_depth=4, rr_reference=False, inv_spp=1.0)

    def state(n):
        lanes = torch.zeros(1, dtype=torch.int32).expand(n)
        return {"slot": lanes, "seeds": lanes}

    for n in (NARROW_LANES - 1, NARROW_LANES, NARROW_LANES + 1, MAX_LANES):
        with pytest.raises(ValueError, match="CUDA"):
            fs.fused_stream_step_cuda({}, state(n), None, None, None, **kw)
    with pytest.raises(ValueError, match=r"stream step's lanes: .*int32: at most 2147483647 \(2\^31 - 1\)"):
        fs.fused_stream_step_cuda({}, state(MAX_LANES + 1), None, None, None, **kw)
    launcher = code("fused_schedule.cu")
    assert "if (entry == 0 && dependent) return static_cast<int>(cudaErrorInvalidValue);" in launcher
    assert "p->n >= kNarrowLanes" not in launcher and "fused_step_kernel<true><<<" in launcher


@pytest.mark.parametrize("step", ["plain", "kernel"])
def test_regen_schedule_needs_the_loops_mask_buffer(step):
    """The regen schedule writes its mask into the loop's buffer
    st["regen"]: both versions refuse a state without it, before any
    launch."""
    tb, st = make_state(64, 0.5, "regen", "off", 6)
    st.pop("regen")
    tb_t = {k: torch.from_numpy(v) for k, v in tb.items()}
    st_t = {k: torch.from_numpy(v) for k, v in st.items()}
    fn = fs.path_step_plain if step == "plain" else fs.path_step_cuda
    with pytest.raises(ValueError, match="regen"):
        fn(tb_t, st_t, schedule="regen", spp=SPP, max_depth=MAX_DEPTH, rr_reference=True, nee=False)


# ---------------------------------------------------------------------------
# path_step_plain on the states the loop reaches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nee", NEE_MODES)
@pytest.mark.parametrize("rr_mode", ["reference", "standard"])
@pytest.mark.parametrize("schedule", ["rays", "regen"])
def test_plain_leaves_ended_lanes_unchanged(schedule, rr_mode, nee):
    """From a fresh loop state (every lane live, accum +0.0, the regen
    buffer 0), 24 steps of path_step_plain on new payloads (radiances with
    -0.0 in them, so that results of -0.0 come): at every step each lane
    ended at entry keeps every field bit for bit (its byte of the regen
    mask 0), and accum never holds -0.0."""
    n, rr_reference = 2000, rr_mode == "reference"
    _, st = make_state(n, 0.0, schedule, nee, 2)
    if schedule == "regen":
        st.update(accum=np.zeros((n, 3), dtype=np.float32), sample_i=np.zeros(n, dtype=np.int32),
                  regen=np.zeros(n, dtype=bool))
    flag = FLAG[schedule]
    lane_keys = [k for k in st if st[k].ndim and k != "regen"]
    for step in range(24):
        tb = make_state(n, 0.0, schedule, nee, 200 + step)[0]
        tb["radiance"][step::7] = -0.0
        new = plain_step(tb, st, schedule, nee, rr_reference)
        ended = st[flag]
        for k in lane_keys:
            assert np.array_equal(bits(new[k])[ended], bits(st[k])[ended]), (step, k)
        if schedule == "regen":
            assert not new["regen"][ended].any()
            assert not (np.signbit(new["accum"]) & (new["accum"] == 0)).any(), step
        st = new
    assert st[flag].mean() > 0.5


# ---------------------------------------------------------------------------
# The sources
# ---------------------------------------------------------------------------

def test_path_step_waits_once_and_stores_nothing_before():
    """path_step_kernel: the trigger first, one wait; before it no payload
    field (p.tb_*) is read and nothing is stored, and only the flag and
    the lane's own state are read; after it every payload field is read."""
    text = body("fused_schedule.cu", "path_step_kernel")
    assert text.count(WAIT) == 1 and text.strip().startswith(TRIGGER)
    pre, _, post = text.partition(WAIT)
    assert not STORE.search(pre), STORE.search(pre)
    assert len(STORE.findall(post)) >= 12  # the stores, the grid sum and the totals, all after it
    assert "atomic" not in pre and "grid_sum" not in pre and "__syncthreads" not in pre
    assert fields_read(pre) == {"flag", "depth", "sample_i", "accum"}
    assert {f for f in fields_read(post) if f.startswith("tb_")} == {
        "tb_seeds", "tb_done", "tb_attenuation", "tb_radiance", "tb_origin", "tb_direction", "tb_hit", "tb_spec"}
    assert "__ldg" not in text  # the payload is the launch before's: coherent loads after the wait


def test_bounce_kernel_lets_the_path_step_start_at_entry():
    """The bounce kernel (the launch before the path step without NEE) and
    the NEE kernel (under NEE) trigger first thing; the bounce kernel stays
    an ordinary launch behind the closest-hit traversal."""
    for source, kernel in (("bounce.cu", "bounce_kernel"), ("nee.cu", "nee_kernel")):
        statements = [s.strip() for s in body(source, kernel).split(";")]
        first = next(s for s in statements if not s.startswith(("using namespace", "namespace")))
        assert first + ";" == TRIGGER, (source, first)
    assert "launch_order::launch(" not in code("bounce.cu") and "bounce_kernel<<<" in code("bounce.cu")


def test_dependent_path_step_refuses_copied_payload():
    """path_step_cuda(..., dependent=True) raises before any build where a
    payload tensor is not contiguous (kernel_arg would copy it just before
    the launch, which would then be the launch before)."""
    tb, st = make_state(64, 0.5, "rays", "off", 4)
    tb_t = {k: torch.from_numpy(v) for k, v in tb.items()}
    st_t = {k: torch.from_numpy(v) for k, v in st.items()}
    tb_t["origin"] = torch.from_numpy(np.ascontiguousarray(tb["origin"].T)).T
    kw = dict(schedule="rays", spp=1, max_depth=MAX_DEPTH, rr_reference=True, nee=False)
    with pytest.raises(ValueError, match="dependent"):
        fs.path_step_cuda(tb_t, st_t, dependent=True, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        fs.path_step_cuda(tb_t, st_t, **kw)


def test_integrator_asks_for_a_dependent_path_step_behind_the_bounce_kernels():
    """render_rays' and render_pixels_regen's steps call the path step
    right after the trace, with `dependent` where `_trace_bounce` took the
    kernels (`_bounce_on_card`), whose last launch is the bounce kernel or,
    under NEE, the NEE kernel; render_pixels_regen keeps its regen mask in
    a loop buffer, zeroed at the frame's start."""
    src = Path(integrator.__file__).read_text()
    kernels = src[src.index("def _bounce_kernels"):src.index("def _bounce_plain")]
    assert kernels.rstrip().splitlines()[-3].strip().startswith("spec_next = bounce_ops.next_event(")
    assert "occluded_scene(" in kernels and "bounce_ops.bounce(" in kernels
    for name in ("_rays_step", "_regen_step"):
        step = src[src.index(f"def {name}"):]
        step = step[:step.index("\n\n\n")]
        assert 'dependent=_bounce_on_card(cfg, st["seeds"].device)' in step
        inner = step[step.index("def step():"):]
        call = inner.index("path_step(tb, st, **kw)")
        assert inner.index("tb = _trace_bounce(") < call
        assert "(" not in inner[inner.index("st[\"spec_last\"])") + len("st[\"spec_last\"])"):call].replace(
            "regen = ", "").strip()
    regen = src[src.index("def render_pixels_regen"):src.index("def _regen_step")]
    assert "regen=exhausted" in regen
    assert integrator._bounce_on_card(integrator.RenderConfig(), "cpu") is False
