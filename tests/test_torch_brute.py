"""Brute-force intersection (every ray against every triangle) on the CPU:
the port's intersect_brute and occluded_brute against the JAX package's
on the same rays, exact ties, triangle counts around the kernel's tile
and the plain version's block, the `active` contract of occluded_scene,
the wrappers' refusal of CPU tensors and their lack of any fallback,
numpy models of how csrc/brute.cu splits the work (the closest hit: a
ray's triangles over its threads, rays a thread, the gate's warp votes,
the merge of the winners; the any hit: each block's listing of its live
rays, tile by tile), and small renders through brute force against the
JAX package.  The gate itself: tests/test_torch_brute_design.py.  The kernels against their plain versions on
the card: tests/test_torch_cuda.py."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several worker processes: one intra-op thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_brute_design import gate_table  # noqa: E402
from test_torch_intersect import assert_close_fma, random_rays  # noqa: E402
from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402
from tpu_pathtracer.ops import intersect as j_isect  # noqa: E402
from tpu_pathtracer.render import envmap as j_envmap  # noqa: E402
from tpu_pathtracer.render import integrator as j_integ  # noqa: E402
from tpu_pathtracer.render.camera import Camera as JCamera  # noqa: E402
from tpu_pathtracer.scene import procedural as j_proc  # noqa: E402
from tpu_pathtracer.scene import scene as j_scene  # noqa: E402
from tpu_pathtracer.utils.image import procedural_hdr  # noqa: E402

from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops import cuda_build  # noqa: E402
from tpu_pathtracer_torch.ops import intersect as isect  # noqa: E402
from tpu_pathtracer_torch.render import envmap, integrator  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402
from tpu_pathtracer_torch.scene import procedural, scene  # noqa: E402

T_MIN, T_MAX = 0.01, 1e16
MISS = 0x7FFFFFFF
TILE = 256  # csrc/brute.cu's kThreads: the triangles of a staged tile


def scene_pair(name):
    """(JAX vertices, port vertices) of a scene: the headline's three
    spheres (3,074 triangles) or config 4's generator cut to 2,882."""
    if name == "spheres":
        return np.asarray(j_proc.three_spheres_scene().vertices), procedural.three_spheres_scene(device="cpu").vertices
    return (np.asarray(j_proc.high_poly_scene(total_tris=3000).vertices),
            procedural.high_poly_scene(total_tris=3000, device="cpu").vertices)


def rays_at(vertices, seed, n):
    """n rays from around the scene (the origins of
    tests/test_torch_intersect.py's random_rays) toward random triangles'
    centroids, a quarter of them in random directions (most miss), as
    float32 numpy arrays."""
    rs = np.random.RandomState(seed)
    v = np.asarray(vertices, dtype=np.float32).reshape(-1, 3, 3)
    o = (rs.randn(n, 3) * np.array([5.0, 2.0, 5.0]) + np.array([0.0, 2.5, 0.0])).astype(np.float32)
    d = v[rs.randint(0, v.shape[0], n)].mean(axis=1) - o
    d[: n // 4] = rs.randn(n // 4, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def port_brute(vertices, o, d, t_max=T_MAX, block=256):
    return isect.intersect_brute(torch.as_tensor(vertices), torch.as_tensor(o), torch.as_tensor(d), T_MIN, t_max,
                                 block)


def jax_brute(vertices, o, d, t_max=T_MAX):
    return j_isect.intersect_brute(jnp.asarray(vertices), jnp.asarray(o), jnp.asarray(d), T_MIN, t_max)


def assert_hit_matches_jax(ht, hj):
    """prim and hit exact; t and bary by the FMA-aware rule of
    tests/test_torch_intersect.py (XLA:CPU contracts a*b+c into one
    rounding, the port rounds each operation)."""
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    np.testing.assert_array_equal(ht.hit.numpy(), np.asarray(hj.hit))
    assert_close_fma(ht.t.numpy(), np.asarray(hj.t), rtol=1e-6)
    assert_close_fma(ht.bary.numpy(), np.asarray(hj.bary), atol=1e-5, loose=10.0)


def same_hit(a, b) -> bool:
    """Bit-equal Hits."""
    return all(torch.equal(getattr(a, f).view(torch.int32) if getattr(a, f).is_floating_point() else getattr(a, f),
                           getattr(b, f).view(torch.int32) if getattr(b, f).is_floating_point() else getattr(b, f))
               for f in ("t", "prim", "bary", "hit"))


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["spheres", "high_poly"])
def test_brute_matches_jax(name):
    """Closest hit and any hit (over the whole ray and a segment) on the
    headline's scene and config 4's generator, 1,500 of
    tests/test_torch_intersect.py's random rays."""
    jv, tv = scene_pair(name)
    o, d = random_rays(1, 1500)
    ht, hj = port_brute(tv, o, d), jax_brute(jv, o, d)
    assert_hit_matches_jax(ht, hj)
    assert 300 < int(ht.hit.sum()) < 1450
    for t_max in (T_MAX, 2.0):
        want = j_isect.occluded_brute(jnp.asarray(jv), jnp.asarray(o), jnp.asarray(d), T_MIN, t_max)
        got = isect.occluded_brute(tv, torch.as_tensor(o), torch.as_tensor(d), T_MIN, t_max)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("t_count", [1, 7, 256, 257, 3074])
def test_brute_triangle_counts_match_jax(t_count):
    """The headline's first T triangles (the ground's two, then the
    spheres'), T around the kernel's tile and the plain version's block of
    256 (one, a few, one tile, one past it, the whole scene), on 700 random
    rays."""
    jv, tv = scene_pair("spheres")
    jv, tv = jv[:t_count], tv[:t_count]
    o, d = random_rays(2, 700)
    ht, hj = port_brute(tv, o, d), jax_brute(jv, o, d)
    assert_hit_matches_jax(ht, hj)
    assert int(ht.hit.sum()) > 0
    want = j_isect.occluded_brute(jnp.asarray(jv), jnp.asarray(o), jnp.asarray(d), T_MIN, T_MAX)
    got = isect.occluded_brute(tv, torch.as_tensor(o), torch.as_tensor(d), T_MIN, T_MAX)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), ht.hit.numpy())


def test_brute_takes_no_rays():
    """N = 0: empty outputs of the Hit's shapes and types."""
    tv = scene_pair("spheres")[1]
    empty = torch.zeros((0, 3))
    h = isect.intersect_brute(tv, empty, empty, T_MIN, T_MAX)
    assert h.t.shape == h.prim.shape == h.hit.shape == (0,) and h.bary.shape == (0, 2)
    assert (h.t.dtype, h.prim.dtype, h.bary.dtype, h.hit.dtype) == (torch.float32, torch.int32, torch.float32,
                                                                     torch.bool)
    occ = isect.occluded_brute(tv, empty, empty, T_MIN, T_MAX, active=torch.zeros(0, dtype=torch.bool))
    assert occ.shape == (0,) and occ.dtype == torch.bool


@pytest.mark.parametrize("layout", ["adjacent", "appended"], ids=["one_block", "across_blocks"])
def test_exact_ties_go_to_the_lowest_id(layout):
    """Each triangle twice, at ids 2k and 2k + 1 (one block of 256, one
    tile) or at k and k + T (in different blocks and tiles): every hit
    goes to the lower id, in both packages, with the single copy's t and
    bary bit for bit."""
    jv, tv = scene_pair("spheres")
    jv, tv = jv[:600], tv[:600]
    o, d = random_rays(3, 800)
    if layout == "adjacent":
        j2, t2 = np.repeat(jv, 2, axis=0), torch.repeat_interleave(tv, 2, dim=0)
        lower = lambda prim: np.where(prim >= 0, 2 * prim, -1)  # noqa: E731
    else:
        j2, t2 = np.concatenate([jv, jv]), torch.cat([tv, tv])
        lower = lambda prim: prim  # noqa: E731
    single, doubled = port_brute(tv, o, d), port_brute(t2, o, d)
    assert int(single.hit.sum()) > 300
    np.testing.assert_array_equal(doubled.prim.numpy(), lower(single.prim.numpy()))
    for f in ("t", "bary", "hit"):
        assert torch.equal(getattr(doubled, f), getattr(single, f)), f
    j_prim = np.asarray(jax_brute(j2, o, d).prim)
    assert ((j_prim % 2 == 0) if layout == "adjacent" else (j_prim < 600))[j_prim >= 0].all()
    np.testing.assert_array_equal(j_prim, doubled.prim.numpy())


@pytest.mark.parametrize("t_count", [257, 3074])
def test_plain_independent_of_block(t_count):
    """The plain versions give the same bits at blocks of 8, 100, 256 and
    4,096 triangles (cfg.intersect_block changes no result, and the
    kernel has no block)."""
    tv = scene_pair("spheres")[1][:t_count]
    o, d = (torch.as_tensor(x) for x in rays_at(tv.numpy(), 4, 600))
    hits = [isect.intersect_brute_plain(tv, o, d, T_MIN, T_MAX, block) for block in (8, 100, 256, 4096)]
    occs = [isect.occluded_brute_plain(tv, o, d, T_MIN, 3.0, block) for block in (8, 100, 256, 4096)]
    for h, occ in zip(hits[1:], occs[1:]):
        assert same_hit(h, hits[0]) and torch.equal(occ, occs[0])
    assert 0 < int(occs[0].sum()) < int(hits[0].hit.sum())


@pytest.mark.parametrize("inactive", ["none", "some", "every"])
def test_occluded_scene_brute_active_lanes(inactive):
    """occluded_scene on a scene without an accel passes `active` to the
    brute any hit: its flags equal the JAX package's on the active lanes
    (the others' are unspecified)."""
    jv, tv = scene_pair("spheres")
    o, d = rays_at(jv, 5, 900)
    active = {"none": np.ones(900, bool), "some": np.random.RandomState(6).rand(900) < 0.4,
              "every": np.zeros(900, bool)}[inactive]
    cfg, jcfg = RenderConfig(intersector="auto"), JConfig(intersector="auto")
    t_scene = procedural.three_spheres_scene(device="cpu")
    j_sc = j_proc.three_spheres_scene()
    got = isect.occluded_scene(t_scene, torch.as_tensor(o), torch.as_tensor(d), T_MIN, T_MAX, cfg,
                               active=torch.as_tensor(active)).numpy()
    want = np.asarray(j_isect.occluded_scene(j_sc, jnp.asarray(o), jnp.asarray(d), T_MIN, T_MAX, jcfg,
                                             active=jnp.asarray(active)))
    np.testing.assert_array_equal(got[active], want[active])
    assert got.shape == (900,) and got.dtype == bool
    if inactive == "none":
        assert 100 < got.sum() < 800


# ---------------------------------------------------------------------------
# The wrappers: no CPU tensors on the kernel path, no fallback
# ---------------------------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' entries never run the plain version: CPU tensors are
    refused before anything is built or counted."""
    tv = scene_pair("spheres")[1]
    o, d = (torch.as_tensor(x) for x in rays_at(tv.numpy(), 7, 32))
    before = isect.intersect_brute.launches, isect.occluded_brute.launches
    with pytest.raises(ValueError, match="CUDA"):
        isect.intersect_brute_cuda(tv, o, d, T_MIN, T_MAX)
    with pytest.raises(ValueError, match="CUDA"):
        isect.occluded_brute_cuda(tv, o, d, T_MIN, T_MAX, active=torch.ones(32, dtype=torch.bool))
    assert (isect.intersect_brute.launches, isect.occluded_brute.launches) == before


def test_on_card_dispatch_never_runs_the_plain_versions(monkeypatch):
    """Where ops.cuda_build.on_card says the kernel runs, intersect_brute,
    occluded_brute and the scene dispatches take the kernel's entry and
    nothing else: here it refuses the CPU tensors, and the plain versions
    are never called.  Off the card they run the plain versions, and
    count no launch."""
    tv = scene_pair("spheres")[1]
    o, d = (torch.as_tensor(x) for x in rays_at(tv.numpy(), 8, 64))
    want_hit, want_occ = isect.intersect_brute_plain(tv, o, d, T_MIN, T_MAX), isect.occluded_brute_plain(
        tv, o, d, T_MIN, T_MAX)
    before = isect.intersect_brute.launches, isect.occluded_brute.launches
    assert same_hit(isect.intersect_brute(tv, o, d, T_MIN, T_MAX), want_hit)
    assert torch.equal(isect.occluded_brute(tv, o, d, T_MIN, T_MAX), want_occ)
    assert (isect.intersect_brute.launches, isect.occluded_brute.launches) == before

    def never(*args, **kw):
        raise AssertionError("the plain version ran where the kernel should")

    monkeypatch.setattr(isect, "on_card", lambda device: True)
    monkeypatch.setattr(isect, "intersect_brute_plain", never)
    monkeypatch.setattr(isect, "occluded_brute_plain", never)
    sc, cfg = procedural.three_spheres_scene(device="cpu"), RenderConfig(intersector="brute")
    for call in (lambda: isect.intersect_brute(tv, o, d, T_MIN, T_MAX),
                 lambda: isect.occluded_brute(tv, o, d, T_MIN, T_MAX),
                 lambda: isect.intersect_scene(sc, o, d, T_MIN, T_MAX, cfg),
                 lambda: isect.occluded_scene(sc, o, d, T_MIN, T_MAX, cfg, active=torch.ones(64, dtype=torch.bool))):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_plain_switch_and_other_devices():
    """Under ops.cuda_build.plain() a CPU call is what it was; a device
    with neither kernels nor plain versions is refused."""
    tv = scene_pair("spheres")[1][:100]
    o, d = (torch.as_tensor(x) for x in rays_at(tv.numpy(), 9, 50))
    with cuda_build.plain():
        assert same_hit(isect.intersect_brute(tv, o, d, T_MIN, T_MAX), isect.intersect_brute_plain(tv, o, d, T_MIN,
                                                                                                   T_MAX))
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernels"):
        isect.intersect_brute(tv, meta, meta, T_MIN, T_MAX)


# ---------------------------------------------------------------------------
# Numpy models of csrc/brute.cu's split of the work: the closest hit's
# threads a ray, rays a thread, votes and merge; the any hit's listing
# ---------------------------------------------------------------------------

def fired_votes(passes, p, r):
    """[N, T] bool: whether the warp vote that covers each pair takes the
    tail.  Lane l of warp w tests with its ray group 32w/p + l/p (rays
    group * r + i, one vote for each i) the triangles j0 + l % p of a step
    j0; a vote is the OR of the gate over its 32 lanes."""
    n, t_count = passes.shape
    g = 32 // p
    pad_n, pad_t = (-n) % (g * r), (-t_count) % p
    x = np.pad(passes, ((0, pad_n), (0, pad_t)))
    w, c = x.shape[0] // (g * r), x.shape[1] // p
    fired = x.reshape(w, g, r, c, p).any(axis=(1, 4), keepdims=True)
    return np.broadcast_to(fired, (w, g, r, c, p)).reshape(x.shape)[:n, :t_count]


def kernel_model(t, u, v, valid, p, passes=None, r=1, tile=TILE):
    """brute_kernel's closest hit with p threads a ray and r rays a thread,
    on the per-pair tests of _mt_block ([N,T] numpy arrays) and the gate
    (`passes`, [N,T]; None: every pair runs the tail): a pair's tail runs
    where its warp's vote takes it (fired_votes); thread s of a ray scans
    the staged tiles' triangles s, s + p, ... in order, keeping a strictly
    smaller t; the p winners merge by the xor butterfly of the kernel's
    shuffles, smaller t then lower id.  Returns (t, prim, u, v), prim MISS
    on a miss."""
    n, t_count = t.shape
    if passes is not None:
        valid = valid & fired_votes(passes, p, r)
    ids = np.arange(t_count)
    # thread s's triangles, in its scan order: tile by tile, j = s, s + p, ...
    order = [np.concatenate([base + np.arange(s, min(tile, t_count - base), p) for base in range(0, t_count, tile)]
                            + [np.zeros(0, int)]) for s in range(p)]
    best = []
    for s in range(p):
        cols = order[s]
        if cols.size == 0:  # a thread past the last triangle keeps the miss
            best.append([np.full(n, T_MAX, np.float32), np.full(n, MISS), np.zeros(n, np.float32),
                         np.zeros(n, np.float32)])
            continue
        tt = np.where(valid[:, cols], t[:, cols], np.float32(np.inf))
        k = np.argmin(tt, axis=1)  # the first of equal t: a strict <
        found = tt[np.arange(n), k] < T_MAX
        win = cols[k]
        best.append([np.where(found, tt[np.arange(n), k], np.float32(T_MAX)), np.where(found, ids[win], MISS),
                     np.where(found, u[np.arange(n), win], 0), np.where(found, v[np.arange(n), win], 0)])
    offset = 1
    while offset < p:
        merged = []
        for s in range(p):
            mine, other = best[s], best[s ^ offset]
            take = (other[0] < mine[0]) | ((other[0] == mine[0]) & (other[1] < mine[1]))
            merged.append([np.where(take, o, m) for o, m in zip(other, mine)])
        best, offset = merged, offset * 2
    assert all(np.array_equal(best[0][1], b[1]) for b in best)  # every thread holds the winner
    return best[0]


def any_hit_model(valid, passes, active, slice_, compact=True, tile=TILE):
    """brute_kernel's any hit on the per-pair tests and gate ([N,T]):
    block b of B = ceil(N / slice_) holds rays b, b + B, ...; it lists its
    rays of `active` in lane order, and for each tile of triangles every
    thread (one triangle) tests every listed ray, behind one vote of its
    warp's 32 triangles a ray (a warp past the last triangle skips); a
    ray's flag is the OR over every test; after a tile the rays not yet
    occluded are listed again, the block stops when none is left.
    compact=False lists every ray of the slice once and never drops one
    (BRUTE_COMPACT 0).  Returns the flags (False off `active`) and the
    tests run."""
    n, t_count = valid.shape
    blocks = -(-n // slice_)
    flags, tests = np.zeros(n, bool), 0
    for b in range(blocks):
        rays = b + np.arange(slice_) * blocks
        rays = rays[rays < n]
        wanted = active[rays]
        live = wanted.copy() if compact else np.ones(rays.size, bool)
        occluded = np.zeros(rays.size, bool)
        for base in range(0, t_count, tile):
            listed = np.flatnonzero(live)
            if listed.size == 0:
                break
            for w in range(base, min(base + tile, t_count), 32):
                cols = np.arange(w, min(w + 32, t_count))
                vote = passes[rays[listed]][:, cols].any(axis=1)
                occluded[listed] |= (valid[rays[listed]][:, cols] & vote[:, None]).any(axis=1)
                tests += 32 * listed.size
            if compact:
                live &= ~occluded
        flags[rays] = wanted & occluded
    return flags, tests


@functools.lru_cache(maxsize=None)
def model_case(t_count, seed, doubled=True):
    """_mt_block's tests and the gate of 300 rays (rays_at) against the
    headline's first t_count triangles, twice (ids k and k + T) where
    `doubled`: (vertices, o, d, t, u, v, valid, passes) as numpy."""
    tv = scene_pair("spheres")[1][:t_count]
    if doubled:
        tv = torch.cat([tv, tv])
    o, d = (torch.as_tensor(x) for x in rays_at(tv.numpy(), seed, 300))
    t, u, v, valid = (x.numpy() for x in isect._mt_block(o, d, tv, T_MIN, T_MAX))
    passes = gate_table(tv.numpy(), o.numpy(), d.numpy())
    return tv, o, d, t, u, v, valid, passes


@pytest.mark.parametrize("t_count", [7, 257, 3074])
@pytest.mark.parametrize("p", [1, 2, 4, 8, 16, 32])
def test_kernel_split_and_merge_model(p, t_count):
    """At every threads-a-ray count the kernel instantiates (1 to 32) and
    every rays-a-thread count (1, 2 and 4), with the gate and the warp's
    vote in front of the tail, the model's winner is the plain version's
    Hit bit for bit: t and prim, and the winner's u and v from the loop
    are the bits finalize_hit's second test recomputes (the same
    operations on the same inputs).  Ties included: the triangles twice,
    at k and k + T.  The gate passes every pair the test accepts."""
    tv, o, d, t, u, v, valid, passes = model_case(t_count, 10 + p)
    assert not (valid & ~passes).any()
    want = isect.intersect_brute_plain(tv, o, d, T_MIN, T_MAX)
    for r in (1, 2, 4):
        mt, mp, mu, mv = kernel_model(t, u, v, valid, p, passes, r)
        hit = mp != MISS
        assert np.array_equal(hit, want.hit.numpy()) and hit.sum() > 50
        np.testing.assert_array_equal(np.where(hit, mp, -1), want.prim.numpy())
        np.testing.assert_array_equal(mt.astype(np.float32).view(np.int32), want.t.numpy().view(np.int32))
        bary = np.where(hit[:, None], np.stack([mu, mv], axis=-1), 0.0).astype(np.float32)
        np.testing.assert_array_equal(bary.view(np.int32), want.bary.numpy().view(np.int32))


ACTIVE = {"none": lambda n: np.zeros(n, bool), "some": lambda n: np.random.RandomState(5).rand(n) < 0.4,
          "all": lambda n: np.ones(n, bool)}


@pytest.mark.parametrize("order", ["scene", "reversed"])
@pytest.mark.parametrize("active", list(ACTIVE))
@pytest.mark.parametrize("slice_,compact", [(32, True), (100, True), (256, True), (100, False)],
                         ids=["slice32", "slice100", "slice256", "no_compact"])
def test_any_hit_listing_model(slice_, compact, active, order):
    """The any hit's listing and re-listing (any_hit_model) at slices of
    32, 100 and 256 rays, and with every ray of a slice listed once
    (BRUTE_COMPACT 0), for no, some and all rays active and the triangles
    in the scene's order or reversed (occluders found early or late): the
    flags equal occluded_brute_plain's on the active lanes and are False
    off them.  With compaction, an inactive ray costs no test and a block
    runs no more tests than one that lists every ray."""
    tv, o, d, t, u, v, valid, passes = model_case(3074, 20, doubled=False)
    if order == "reversed":
        tv, valid, passes = torch.flip(tv, (0,)), valid[:, ::-1], passes[:, ::-1]
    mask = ACTIVE[active](o.shape[0])
    flags, tests = any_hit_model(valid, passes, mask, slice_, compact)
    want = isect.occluded_brute_plain(tv, o, d, T_MIN, T_MAX).numpy()
    np.testing.assert_array_equal(flags[mask], want[mask])
    assert not flags[~mask].any() and 0 < want.sum() < want.size
    if compact:
        assert tests <= any_hit_model(valid, passes, np.ones_like(mask), slice_, compact=False)[1]
        assert (tests == 0) == (active == "none")


# ---------------------------------------------------------------------------
# Renders through brute force at the goldens' size
# ---------------------------------------------------------------------------

EYE = dict(eye=(0.0, 2.0, 6.0), lookat=(0.0, 0.5, 0.0))
RENDERS = {
    # the bench's config 0 path: the fused stream, no NEE
    "fused": dict(fused_schedule="on"),
    # config 3's: NEE, the unfused stream, one any-hit pass an iteration
    "nee": dict(rr_mode="standard", env_importance_sampling=True),
}


@pytest.mark.parametrize("case", list(RENDERS))
def test_brute_render_matches_jax(case):
    """A 64x48, 2-spp, depth-4 frame of three spheres without an accel
    ("auto" takes brute force in both packages) against the JAX package's
    by the render rule of tests/test_torch_render.py: 99% of values within
    rtol 1e-3, atol 1e-4, channel means within 1%, segments and shadow
    segments within 0.5%."""
    hdr = procedural_hdr(32, 64)
    kw = dict(width=64, height=48, samples_per_launch=2, max_depth=4, dof=False, stream_lanes=256,
              intersector="auto", env_mode="equirect", **RENDERS[case])
    nee = kw.get("env_importance_sampling", False)
    j_env, t_env = j_scene.make_env(hdr), scene.make_env(hdr, "cpu")
    if nee:
        j_env, t_env = j_envmap.with_importance_sampling(j_env), envmap.with_importance_sampling(t_env)
    j = j_proc.three_spheres_scene(8, 16).replace(env=j_env)
    t = procedural.three_spheres_scene(8, 16, device="cpu").replace(env=t_env)
    jcfg, tcfg = JConfig(**kw), RenderConfig(**kw)
    jax.clear_caches()
    try:
        jimg, jstats = j_integ.render_frame_stats(j, j_integ.camera_arrays(JCamera(**EYE), jcfg), jcfg, jnp.int32(1))
        jimg = np.asarray(jimg)
        jstats = {k: int(v) for k, v in jstats.items()}
    finally:
        jax.clear_caches()
    timg, tstats = integrator.render_frame_stats(t, camera_arrays(Camera(**EYE), tcfg, "cpu"), tcfg, 1)
    timg = timg.numpy()
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, f"only {close.mean():.4%} of values agree"
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)), rtol=0.01)
    assert np.isfinite(timg).all() and timg.max() > 0
    for key in ("segments", "shadow_segments"):
        got, want = int(tstats[key]), jstats[key]
        assert abs(got - want) <= 0.005 * want, (key, got, want)
    assert (jstats["shadow_segments"] > 0) == nee


def test_brute_render_independent_of_block():
    """The same frame's bits at intersect_block 8 and 4,096, with NEE."""
    env = envmap.with_importance_sampling(scene.make_env(procedural_hdr(32, 64), "cpu"))
    t = procedural.three_spheres_scene(6, 12, device="cpu").replace(env=env)
    images = []
    for block in (8, 4096):
        cfg = RenderConfig(width=32, height=24, samples_per_launch=2, max_depth=3, dof=False, stream_lanes=256,
                           intersector="brute", env_mode="equirect", rr_mode="standard",
                           env_importance_sampling=True, intersect_block=block)
        images.append(integrator.render_frame_stats(t, camera_arrays(Camera(**EYE), cfg, "cpu"), cfg, 0)[0])
    assert torch.equal(images[0], images[1]) and float(images[0].max()) > 0
