"""The PyTorch port's intersectors against the JAX package: the coherence
sort key and permutation, the flat, two-level and streamed packet
traversals (plain versions vs the Pallas kernels in interpret mode, with
both triangle tests), ClusterAccel.intersect on each route and brute
force, and the same for the any-hit side (the three occlusion kernels,
ClusterAccel.occluded with parked lanes, occluded_brute).  The CUDA
kernels are compared with their plain versions on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several worker processes: one intra-op thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.accel.build import build_accel as j_build_accel  # noqa: E402
from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402
from tpu_pathtracer.ops import intersect as j_isect  # noqa: E402
from tpu_pathtracer.ops import intersect_pallas as j_pallas  # noqa: E402
from tpu_pathtracer.scene import procedural as j_proc  # noqa: E402

from tpu_pathtracer_torch.accel import cluster as cluster_mod  # noqa: E402
from tpu_pathtracer_torch.accel.build import build_accel  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops import intersect as isect  # noqa: E402
from tpu_pathtracer_torch.ops import intersect_cluster as ic  # noqa: E402
from tpu_pathtracer_torch.ops import ray_sort  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402

T_MIN, T_MAX = 0.01, 1e16
RPT = 1024  # the JAX accel's rays per packet on flat-kernel scenes
RPT_HIER = 512  # ... and from cfg.hier_min_clusters clusters up


def assert_close_fma(got, want, rtol=0.0, atol=0.0, loose=30.0, share=0.995):
    """Float outputs against the JAX package run on the CPU.

    XLA:CPU contracts a*b+c into one fused multiply-add (jit(a*b+c) gives
    the singly rounded result), while the port rounds every product and
    sum, as its CUDA kernel does (-fmad=false).  Where the Baldwin-Weber
    numerator cancels, or u = p1.h + c1 cancels against a large c1, that
    one rounding grows.  Measured on 4096 rays: t bit-equal on 81%, within
    rtol 1e-6 on 99.9%, within 1e-5 on all; uv bit-equal on 57%, within
    atol 1e-5 on 99.7%, within 3e-5 on all.  So at least `share` of the
    values must meet (rtol, atol), and all of them `loose` times that."""
    got, want = np.asarray(got), np.asarray(want)
    close = np.isclose(got, want, rtol=rtol, atol=atol)
    assert close.mean() >= share, f"only {close.mean():.5f} within rtol {rtol} atol {atol}"
    np.testing.assert_allclose(got, want, rtol=rtol * loose, atol=atol * loose)


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port scene): three spheres, 1730 triangles in 14
    clusters of 128."""
    j = j_build_accel(j_proc.three_spheres_scene(12, 24), kind="cluster")
    t = build_accel(procedural.three_spheres_scene(12, 24, device="cpu"))
    return j, t


@pytest.fixture(scope="module")
def many():
    """(JAX scene, port scene): three spheres (8, 16), 770 triangles in 97
    clusters of 8, which takes the two-level route; 13 supers of 8, the
    last with one real child and seven padding children."""
    j = j_build_accel(j_proc.three_spheres_scene(8, 16), kind="cluster", cluster_size=8)
    t = build_accel(procedural.three_spheres_scene(8, 16, device="cpu"), cluster_size=8)
    assert t.accel.num_clusters == 97
    return j, t


def random_rays(seed, n, parked=0):
    """Rays from around the scene toward random points on it; the last
    `parked` rays sit at (3e37, 0, 0) pointing +x, as lanes are parked."""
    rs = np.random.RandomState(seed)
    o = (rs.randn(n, 3) * np.array([5.0, 2.0, 5.0]) + np.array([0.0, 2.5, 0.0])).astype(np.float32)
    target = (rs.rand(n, 3) * np.array([8.0, 2.0, 2.0]) - np.array([4.0, 0.0, 1.0])).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    # A quarter of the rays point anywhere, most of them away from the scene.
    k = n // 4
    d[:k] = rs.randn(k, 3).astype(np.float32)
    if parked:
        o[-parked:] = [3.0e37, 0.0, 0.0]
        d[-parked:] = [1.0, 0.0, 0.0]
    return o, d


def pallas(j_acc, o, d):
    bt, bp, buv = j_pallas.intersect_clusters_pallas(
        j_acc.tris16bw, j_acc.aabb8, j_acc.order, jnp.asarray(o), jnp.asarray(d),
        T_MIN, T_MAX, rays_per_tile=RPT, interpret=True, tri_test="bw",
    )
    return np.asarray(bt), np.asarray(bp), np.asarray(buv)


def plain(t_acc, o, d, rpt=RPT):
    t, p, uv = ic.intersect_clusters(
        t_acc.tris16bw, t_acc.aabb8, t_acc.order, torch.as_tensor(o), torch.as_tensor(d),
        T_MIN, T_MAX, rpt,
    )
    return t.numpy(), p.numpy(), uv.numpy()


@pytest.mark.parametrize(
    "spatial_bits,dir_bits", [(0, 0), (0, 2), (7, 2), (5, 3), (9, 4)]
)
def test_ray_sort_key_matches_jax(scenes, spatial_bits, dir_bits):
    j, t = scenes
    o, d = random_rays(0, 5000)
    o[:100] = o[0]  # shared origin cell, as primary rays have
    want = j_pallas.ray_sort_key(
        jnp.asarray(o), jnp.asarray(d), j.accel.scene_lo, j.accel.scene_hi,
        spatial_bits, dir_bits,
    )
    got = ray_sort.ray_sort_key(
        torch.as_tensor(o), torch.as_tensor(d), t.accel.scene_lo, t.accel.scene_hi,
        spatial_bits, dir_bits,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_sort_permutation_matches_jax(scenes):
    j, t = scenes
    o, d = random_rays(1, 5000)
    o_j, d_j, restore_j = j_pallas.octant_sort(
        jnp.asarray(o), jnp.asarray(d), j.accel.scene_lo, j.accel.scene_hi, 7, 2
    )
    o_t, d_t, perm = t.accel.sort(
        torch.as_tensor(o), torch.as_tensor(d),
        RenderConfig(sort_rays="spatial", sort_spatial_bits=7, sort_dir_bits=2),
    )
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    back = ray_sort.restore(o_t, perm)
    np.testing.assert_array_equal(back.numpy(), o)
    np.testing.assert_array_equal(back.numpy(), np.asarray(restore_j(o_j)))


@pytest.mark.parametrize("n,parked", [(4096, 0), (3000, 500)], ids=["random", "parked_padded"])
def test_plain_cluster_intersect_matches_pallas(scenes, n, parked):
    """prim exact; t to rtol 1e-6 and uv to atol 1e-5 (see
    assert_close_fma), at the JAX packet size; 3000 rays also leave a
    partly padded last packet."""
    j, t = scenes
    o, d = random_rays(2, n, parked)
    bt_j, bp_j, buv_j = pallas(j.accel, o, d)
    bt_t, bp_t, buv_t = plain(t.accel, o, d)
    np.testing.assert_array_equal(bp_t, bp_j)
    assert_close_fma(bt_t, bt_j, rtol=1e-6)
    assert_close_fma(buv_t, buv_j, atol=1e-5, loose=10.0)
    hit = bp_j != ic.MISS_PRIM
    assert 0.2 * n < hit.sum() < n - parked
    if parked:
        assert (bp_t[-parked:] == ic.MISS_PRIM).all()


def test_plain_cluster_intersect_matches_brute(scenes):
    """Packet size changes only ties; the closest hit equals brute force."""
    _, t = scenes
    o, d = random_rays(3, 2000)
    bt, bp, buv = plain(t.accel, o, d, rpt=256)
    h = isect.intersect_brute(t.vertices, torch.as_tensor(o), torch.as_tensor(d), T_MIN, T_MAX)
    prim = np.where(bp == ic.MISS_PRIM, -1, bp)
    np.testing.assert_array_equal(prim, h.prim.numpy())
    hit = prim >= 0
    np.testing.assert_allclose(bt[hit], h.t.numpy()[hit], rtol=1e-4)
    np.testing.assert_allclose(buv[hit], h.bary.numpy()[hit], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("sort_rays", ["auto", "off", "octant"])
def test_cluster_accel_intersect_matches_jax(scenes, monkeypatch, sort_rays):
    """ClusterAccel.intersect, sort and restore included, against the JAX
    accel routed through the Pallas kernel in interpret mode."""
    monkeypatch.setenv("TPU_PT_PALLAS_INTERPRET", "1")
    j, t = scenes
    o, d = random_rays(4, 3000, parked=100)
    hj = j.accel.intersect(
        j.vertices, jnp.asarray(o), jnp.asarray(d), T_MIN, T_MAX,
        JConfig(sort_rays=sort_rays, intersector="cluster"),
    )
    ht = t.accel.intersect(
        t.vertices, torch.as_tensor(o), torch.as_tensor(d), T_MIN, T_MAX,
        RenderConfig(sort_rays=sort_rays, intersector="cluster"),
    )
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    np.testing.assert_array_equal(ht.hit.numpy(), np.asarray(hj.hit))
    assert_close_fma(ht.t.numpy(), np.asarray(hj.t), rtol=1e-6)
    assert_close_fma(ht.bary.numpy(), np.asarray(hj.bary), atol=1e-5, loose=10.0)


def test_intersect_brute_matches_jax(scenes):
    j, t = scenes
    o, d = random_rays(5, 1000)
    hj = j_isect.intersect_brute(j.vertices, jnp.asarray(o), jnp.asarray(d), T_MIN, T_MAX)
    ht = isect.intersect_brute(t.vertices, torch.as_tensor(o), torch.as_tensor(d), T_MIN, T_MAX)
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    assert_close_fma(ht.t.numpy(), np.asarray(hj.t), rtol=1e-6)
    assert_close_fma(ht.bary.numpy(), np.asarray(hj.bary), atol=1e-5, loose=10.0)


def test_intersect_scene_auto_routes(scenes):
    """"auto" takes the accel when the scene has one, brute force if not."""
    _, t = scenes
    o, d = random_rays(6, 500)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    cfg = RenderConfig(intersector="auto")
    h_auto = isect.intersect_scene(t, o, d, T_MIN, T_MAX, cfg)
    h_acc = t.accel.intersect(t.vertices, o, d, T_MIN, T_MAX, cfg)
    assert torch.equal(h_auto.prim, h_acc.prim)
    h_brute = isect.intersect_scene(t.replace(accel=None), o, d, T_MIN, T_MAX, cfg)
    assert torch.equal(h_brute.prim, h_acc.prim)
    with pytest.raises(ValueError):
        isect.intersect_scene(t.replace(accel=None), o, d, T_MIN, T_MAX, RenderConfig(intersector="cluster"))


def test_cuda_wrapper_refuses_cpu_tensors(scenes):
    """The kernel's entry never falls back to the plain version: CPU
    tensors are refused before anything is built."""
    _, t = scenes
    acc = t.accel
    o, d = random_rays(9, 32)
    with pytest.raises(ValueError, match="CUDA"):
        ic.intersect_clusters_cuda(
            acc.tris16bw, acc.aabb8, acc.order, torch.as_tensor(o),
            torch.as_tensor(d), T_MIN, T_MAX, RPT,
        )


# ---------------------------------------------------------------------------
# Moller-Trumbore arm, two-level and streamed traversal
# ---------------------------------------------------------------------------

RAYS = pytest.mark.parametrize("n,parked", [(4096, 0), (3000, 500)], ids=["random", "parked_padded"])
TRI = pytest.mark.parametrize("tri_test", ["bw", "mt"])


def rows(acc, tri_test):
    return acc.tris16bw if tri_test == "bw" else acc.tris16


def assert_hits_match(got, want, n, parked):
    """The port's (t, prim, uv) against the JAX kernel's: prim exact, t and
    uv as assert_close_fma; enough hits, and parked rays never hit."""
    bt_t, bp_t, buv_t = (x.numpy() for x in got)
    bt_j, bp_j, buv_j = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(bp_t, bp_j)
    assert_close_fma(bt_t, bt_j, rtol=1e-6)
    assert_close_fma(buv_t, buv_j, atol=1e-5, loose=10.0)
    hit = bp_j != ic.MISS_PRIM
    assert 0.2 * n < hit.sum() < n - parked
    if parked:
        assert (bp_t[-parked:] == ic.MISS_PRIM).all()


@RAYS
def test_plain_cluster_intersect_mt_matches_pallas(scenes, n, parked):
    """The flat traversal with tri_test="mt" against the Pallas kernel's
    Moller-Trumbore arm."""
    j, t = scenes
    o, d = random_rays(2, n, parked)
    want = j_pallas.intersect_clusters_pallas(
        j.accel.tris16, j.accel.aabb8, j.accel.order, jnp.asarray(o), jnp.asarray(d),
        T_MIN, T_MAX, rays_per_tile=RPT, interpret=True, tri_test="mt",
    )
    got = ic.intersect_clusters(
        t.accel.tris16, t.accel.aabb8, t.accel.order, torch.as_tensor(o), torch.as_tensor(d),
        T_MIN, T_MAX, RPT, "mt",
    )
    assert_hits_match(got, want, n, parked)


@RAYS
@TRI
def test_plain_hier_matches_pallas(many, n, parked, tri_test):
    """The two-level plain version against intersect_clusters_pallas_hier
    at the JAX accel's packet size and branch."""
    j, t = many
    ja, ta = j.accel, t.accel
    o, d = random_rays(10, n, parked)
    want = j_pallas.intersect_clusters_pallas_hier(
        rows(ja, tri_test), ja.aabb8_child, ja.aabb8_super, ja.order_super,
        jnp.asarray(o), jnp.asarray(d), T_MIN, T_MAX, rays_per_tile=RPT_HIER,
        branch=ja.super_branch, interpret=True, tri_test=tri_test,
    )
    got = ic.intersect_clusters_hier(
        rows(ta, tri_test), ta.aabb8_child, ta.aabb8_super, ta.order_super,
        torch.as_tensor(o), torch.as_tensor(d), T_MIN, T_MAX, RPT_HIER, ta.super_branch, tri_test,
    )
    assert_hits_match(got, want, n, parked)


STREAMED_PADS = pytest.mark.parametrize(
    "block_clusters,branch", [(96, 16), (4, 2)], ids=["path_branch16", "jax_test_branch2"]
)


@STREAMED_PADS
@TRI
def test_plain_streamed_matches_pallas(many, block_clusters, branch, tri_test):
    """The streamed plain version, over the port's streamed_pads, against
    intersect_clusters_pallas_streamed: at the render path's branch 16 and
    at the JAX kernel test's block_clusters=4, branch=2."""
    j, t = many
    ja, ta = j.accel, t.accel
    n, parked = 3000, 500
    o, d = random_rays(11, n, parked)
    want = j_pallas.intersect_clusters_pallas_streamed(
        rows(ja, tri_test), ja.aabb8, jnp.asarray(o), jnp.asarray(d), T_MIN, T_MAX,
        rays_per_tile=RPT_HIER, block_clusters=block_clusters, branch=branch,
        interpret=True, tri_test=tri_test,
    )
    child, supers = ic.streamed_pads(ta.aabb8, block_clusters, branch)
    got = ic.intersect_clusters_streamed(
        rows(ta, tri_test), child, supers, torch.as_tensor(o), torch.as_tensor(d),
        T_MIN, T_MAX, RPT_HIER, branch, tri_test,
    )
    assert_hits_match(got, want, n, parked)


@pytest.mark.parametrize("block_clusters,branch", [(96, 16), (4, 2), (40, 8), (8, 8)])
def test_streamed_pads_match_jax(many, block_clusters, branch):
    j, t = many
    _, aabbs, supers, _, _ = j_pallas._streamed_pads(j.accel.tris16bw, j.accel.aabb8, block_clusters, branch)
    child, sup = ic.streamed_pads(t.accel.aabb8, block_clusters, branch)
    np.testing.assert_array_equal(child.numpy(), np.asarray(aabbs))
    np.testing.assert_array_equal(sup.numpy(), np.asarray(supers))


def test_streamed_independent_of_block_clusters(many):
    """block_clusters sets only how far the cluster range is padded, and
    padding children are never tested: the results are the same bits."""
    _, t = many
    ta = t.accel
    o, d = (torch.as_tensor(x) for x in random_rays(12, 2000, 100))
    outs = [
        ic.intersect_clusters_streamed(ta.tris16bw, *ic.streamed_pads(ta.aabb8, bc, 8), o, d,
                                       T_MIN, T_MAX, RPT_HIER, 8)
        for bc in (8, 40, 96)
    ]
    assert len({ic.streamed_pads(ta.aabb8, bc, 8)[0].shape[0] for bc in (8, 40, 96)}) == 3
    for other in outs[1:]:
        for x, y in zip(outs[0], other):
            assert torch.equal(x, y)


@pytest.mark.parametrize("route", ["hier", "streamed"])
def test_plain_two_level_matches_brute(many, route):
    """At a small packet size only exact ties in t could differ: the
    closest hit equals brute force."""
    _, t = many
    ta = t.accel
    o, d = (torch.as_tensor(x) for x in random_rays(13, 2000))
    if route == "hier":
        bt, bp, buv = ic.intersect_clusters_hier(
            ta.tris16bw, ta.aabb8_child, ta.aabb8_super, ta.order_super, o, d, T_MIN, T_MAX, 32, 8)
    else:
        bt, bp, buv = ic.intersect_clusters_streamed(
            ta.tris16bw, *ic.streamed_pads(ta.aabb8), o, d, T_MIN, T_MAX, 32, 16)
    h = isect.intersect_brute(t.vertices, o, d, T_MIN, T_MAX)
    prim = torch.where(bp == ic.MISS_PRIM, -1, bp)
    np.testing.assert_array_equal(prim.numpy(), h.prim.numpy())
    hit = prim >= 0
    assert hit.sum() > 400
    np.testing.assert_allclose(bt[hit].numpy(), h.t[hit].numpy(), rtol=1e-4)
    np.testing.assert_allclose(buv[hit].numpy(), h.bary[hit].numpy(), rtol=1e-3, atol=1e-4)


def port_hit_matches_jax(ht, hj):
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    np.testing.assert_array_equal(ht.hit.numpy(), np.asarray(hj.hit))
    assert_close_fma(ht.t.numpy(), np.asarray(hj.t), rtol=1e-6)
    assert_close_fma(ht.bary.numpy(), np.asarray(hj.bary), atol=1e-5, loose=10.0)


@pytest.mark.parametrize(
    "sort_rays,tri_test", [("auto", "auto"), ("off", "auto"), ("octant", "bw"), ("auto", "mt")]
)
def test_cluster_accel_intersect_hier_matches_jax(many, monkeypatch, sort_rays, tri_test):
    """ClusterAccel.intersect on the two-level route, sort and restore
    included, against the JAX accel through the Pallas kernel in
    interpret mode."""
    monkeypatch.setenv("TPU_PT_PALLAS_INTERPRET", "1")
    j, t = many
    cfg = RenderConfig(sort_rays=sort_rays, tri_test=tri_test, intersector="cluster")
    assert t.accel.route(cfg) == "hier"
    o, d = random_rays(14, 3000, parked=100)
    hj = j.accel.intersect(
        j.vertices, jnp.asarray(o), jnp.asarray(d), T_MIN, T_MAX,
        JConfig(sort_rays=sort_rays, tri_test=tri_test, intersector="cluster"),
    )
    ht = t.accel.intersect(t.vertices, torch.as_tensor(o), torch.as_tensor(d), T_MIN, T_MAX, cfg)
    port_hit_matches_jax(ht, hj)


@pytest.mark.parametrize("which,tri_test", [("scenes", "auto"), ("many", "auto"), ("many", "mt")])
def test_cluster_accel_intersect_streamed_matches_jax(request, monkeypatch, which, tri_test):
    """ClusterAccel.intersect on the streamed route (the port's 6 MB line
    patched low) against the JAX accel's streamed branch composed by hand,
    since its line is fixed: octant_sort, intersect_clusters_pallas_streamed
    at twice the super branch, restore."""
    j, t = request.getfixturevalue(which)
    ja = j.accel
    monkeypatch.setattr(cluster_mod, "_FLAT_MAX_BYTES", 1024)
    cfg = RenderConfig(tri_test=tri_test, intersector="cluster")
    jcfg = JConfig(tri_test=tri_test, intersector="cluster")
    assert t.accel.route(cfg) == "streamed"
    o, d = random_rays(15, 3000, parked=100)
    o_s, d_s, back = j_pallas.octant_sort(
        jnp.asarray(o), jnp.asarray(d), ja.scene_lo, ja.scene_hi,
        spatial_bits=7 if ja.num_clusters < 256 else 5, dir_bits=ja._dir_bits(jcfg),
    )
    name, tris = ja._tri(jcfg)
    bt, bp, buv = j_pallas.intersect_clusters_pallas_streamed(
        tris, ja.aabb8, o_s, d_s, T_MIN, T_MAX, rays_per_tile=ja._rpt(jcfg),
        branch=2 * ja.super_branch, interpret=True, tri_test=name,
    )
    bt, bp, buv = np.asarray(back(bt)), np.asarray(back(bp)), np.asarray(back(buv))
    hit = bp != ic.MISS_PRIM
    want = isect.Hit(t=bt, prim=np.where(hit, bp, -1), bary=np.where(hit[:, None], buv, 0.0), hit=hit)
    ht = t.accel.intersect(t.vertices, torch.as_tensor(o), torch.as_tensor(d), T_MIN, T_MAX, cfg)
    port_hit_matches_jax(ht, want)


@pytest.mark.parametrize(
    "which,kw,small_line,want",
    [
        ("scenes", {}, False, ("flat", 1024, None, "bw")),
        ("scenes", dict(hier_min_clusters=8, tri_test="mt"), False, ("hier", 512, 8, "mt")),
        ("many", {}, False, ("hier", 512, 8, "bw")),
        ("many", {}, True, ("streamed", 512, 16, "bw")),
        ("scenes", dict(tri_test="mt"), True, ("streamed", 1024, 16, "mt")),
    ],
    ids=["flat", "hier_by_threshold", "hier", "streamed_many", "streamed_flat_sized"],
)
def test_cluster_accel_dispatch(request, monkeypatch, which, kw, small_line, want):
    """Which kernel ClusterAccel.intersect takes, with which packet size,
    super branch and triangle rows, as the JAX accel decides."""
    _, t = request.getfixturevalue(which)
    if small_line:
        monkeypatch.setattr(cluster_mod, "_FLAT_MAX_BYTES", 1024)
    calls = []

    def spy(route, n_lead):
        def call(*args, restore=False, perm=None):
            tris, rest = args[0], args[n_lead:]
            branch = rest[5] if route != "flat" else None
            calls.append((route, rest[4], branch, rest[-1]))
            assert tris is (t.accel.tris16 if rest[-1] == "mt" else t.accel.tris16bw)
            n = rest[0].shape[0]
            raw = (torch.zeros(n), torch.full((n,), ic.MISS_PRIM, dtype=torch.int32), torch.zeros(n, 2))
            assert restore  # the accel takes its Hit in caller order from the wrapper
            return ray_sort.restore_hits_plain(raw, perm)
        return call

    monkeypatch.setattr(cluster_mod, "intersect_clusters", spy("flat", 3))
    monkeypatch.setattr(cluster_mod, "intersect_clusters_hier", spy("hier", 4))
    monkeypatch.setattr(cluster_mod, "intersect_clusters_streamed", spy("streamed", 3))
    o, d = random_rays(16, 64)
    h = t.accel.intersect(t.vertices, torch.as_tensor(o), torch.as_tensor(d), T_MIN, T_MAX, RenderConfig(**kw))
    assert calls == [want]
    assert not h.hit.any()


@pytest.mark.parametrize("route", ["hier", "streamed"])
def test_two_level_cuda_wrappers_refuse_cpu_tensors(many, route):
    _, t = many
    ta = t.accel
    o, d = (torch.as_tensor(x) for x in random_rays(17, 32))
    with pytest.raises(ValueError, match="CUDA"):
        if route == "hier":
            ic.intersect_clusters_hier_cuda(ta.tris16bw, ta.aabb8_child, ta.aabb8_super, ta.order_super,
                                            o, d, T_MIN, T_MAX, RPT_HIER, 8)
        else:
            ic.intersect_clusters_streamed_cuda(ta.tris16bw, *ic.streamed_pads(ta.aabb8), o, d,
                                                T_MIN, T_MAX, RPT_HIER, 16)


# ---------------------------------------------------------------------------
# Any hit: the shadow rays of next-event estimation
# ---------------------------------------------------------------------------

def assert_flags_match(got, want, n, parked):
    """The port's occluded flags against the JAX kernel's, on every ray
    (no flag flipped by XLA:CPU's fused multiply-adds on these rays); some
    rays occluded and some not, and parked rays never occluded."""
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(got, want)
    assert 0.1 * n < want.sum() < n - parked - 0.1 * n
    if parked:
        assert not got[-parked:].any()


@RAYS
@TRI
def test_plain_occluded_matches_pallas(scenes, n, parked, tri_test):
    """The flat any-hit plain version against occluded_clusters_pallas
    (kernel 4) at the JAX packet size; 3000 rays leave a ragged last
    packet."""
    j, t = scenes
    o, d = random_rays(20, n, parked)
    want = j_pallas.occluded_clusters_pallas(
        rows(j.accel, tri_test), j.accel.aabb8, j.accel.order, jnp.asarray(o), jnp.asarray(d),
        T_MIN, T_MAX, rays_per_tile=RPT, interpret=True, tri_test=tri_test,
    )
    got = ic.occluded_clusters(
        rows(t.accel, tri_test), t.accel.aabb8, t.accel.order, torch.as_tensor(o), torch.as_tensor(d),
        T_MIN, T_MAX, RPT, tri_test,
    )
    assert_flags_match(got, want, n, parked)


@RAYS
@TRI
def test_plain_occluded_hier_matches_pallas(many, n, parked, tri_test):
    """The two-level any-hit plain version against
    occluded_clusters_pallas_hier (kernel 5) at the JAX packet size and
    branch, with the part-padded last super."""
    j, t = many
    ja, ta = j.accel, t.accel
    o, d = random_rays(21, n, parked)
    want = j_pallas.occluded_clusters_pallas_hier(
        rows(ja, tri_test), ja.aabb8_child, ja.aabb8_super, ja.order_super,
        jnp.asarray(o), jnp.asarray(d), T_MIN, T_MAX, rays_per_tile=RPT_HIER,
        branch=ja.super_branch, interpret=True, tri_test=tri_test,
    )
    got = ic.occluded_clusters_hier(
        rows(ta, tri_test), ta.aabb8_child, ta.aabb8_super, ta.order_super,
        torch.as_tensor(o), torch.as_tensor(d), T_MIN, T_MAX, RPT_HIER, ta.super_branch, tri_test,
    )
    assert_flags_match(got, want, n, parked)


@STREAMED_PADS
@TRI
def test_plain_occluded_streamed_matches_pallas(many, block_clusters, branch, tri_test):
    """The streamed any-hit plain version over the port's streamed_pads
    against occluded_clusters_pallas_streamed (kernel 6), at the render
    path's branch 16 and at block_clusters=4, branch=2."""
    j, t = many
    ja, ta = j.accel, t.accel
    n, parked = 3000, 500
    o, d = random_rays(22, n, parked)
    want = j_pallas.occluded_clusters_pallas_streamed(
        rows(ja, tri_test), ja.aabb8, jnp.asarray(o), jnp.asarray(d), T_MIN, T_MAX,
        rays_per_tile=RPT_HIER, block_clusters=block_clusters, branch=branch,
        interpret=True, tri_test=tri_test,
    )
    child, supers = ic.streamed_pads(ta.aabb8, block_clusters, branch)
    got = ic.occluded_clusters_streamed(
        rows(ta, tri_test), child, supers, torch.as_tensor(o), torch.as_tensor(d),
        T_MIN, T_MAX, RPT_HIER, branch, tri_test,
    )
    assert_flags_match(got, want, n, parked)


def test_occluded_streamed_independent_of_block_clusters(many):
    """As for the closest hit: block_clusters only pads, so the flags are
    the same whatever it is."""
    _, t = many
    ta = t.accel
    o, d = (torch.as_tensor(x) for x in random_rays(23, 2000, 100))
    outs = [
        ic.occluded_clusters_streamed(ta.tris16bw, *ic.streamed_pads(ta.aabb8, bc, 8), o, d,
                                      T_MIN, T_MAX, RPT_HIER, 8)
        for bc in (8, 40, 96)
    ]
    for other in outs[1:]:
        assert torch.equal(outs[0], other)
    assert outs[0].any() and not outs[0].all()


def test_occluded_brute_matches_jax(scenes):
    j, t = scenes
    o, d = random_rays(24, 1000)
    for t_max in (T_MAX, 3.0):
        want = j_isect.occluded_brute(j.vertices, jnp.asarray(o), jnp.asarray(d), T_MIN, t_max)
        got = isect.occluded_brute(t.vertices, torch.as_tensor(o), torch.as_tensor(d), T_MIN, t_max)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("route", ["flat", "hier", "streamed"])
@pytest.mark.parametrize("t_max", [T_MAX, 3.0], ids=["infinite", "segment"])
def test_plain_occluded_matches_brute(scenes, many, route, t_max):
    """At a small packet size, the any-hit flags equal brute force: a
    segment is blocked exactly when some triangle meets it (over the whole
    ray, and over a finite segment, where the box votes use t_max)."""
    _, t = scenes if route == "flat" else many
    ta = t.accel
    o, d = (torch.as_tensor(x) for x in random_rays(25, 2000))
    if route == "flat":
        got = ic.occluded_clusters(ta.tris16bw, ta.aabb8, ta.order, o, d, T_MIN, t_max, 32)
    elif route == "hier":
        got = ic.occluded_clusters_hier(ta.tris16bw, ta.aabb8_child, ta.aabb8_super, ta.order_super,
                                        o, d, T_MIN, t_max, 32, 8)
    else:
        got = ic.occluded_clusters_streamed(ta.tris16bw, *ic.streamed_pads(ta.aabb8), o, d, T_MIN, t_max, 32, 16)
    want = isect.occluded_brute(t.vertices, o, d, T_MIN, t_max)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert 200 < int(want.sum()) < 1800


def jax_occluded_streamed(ja, o, d, active, jcfg):
    """The JAX accel's streamed any-hit branch composed by hand (its 6 MB
    line is fixed): park the inactive lanes, octant_sort,
    occluded_clusters_pallas_streamed at twice the super branch, restore."""
    park = ja.scene_hi + (ja.scene_hi - ja.scene_lo) + 1.0
    o = jnp.where(active[:, None], jnp.asarray(o), park[None, :])
    d = jnp.where(active[:, None], jnp.asarray(d), jnp.array([1.0, 0.0, 0.0], jnp.float32))
    o_s, d_s, back = j_pallas.octant_sort(
        o, d, ja.scene_lo, ja.scene_hi,
        spatial_bits=7 if ja.num_clusters < 256 else 5, dir_bits=ja._dir_bits(jcfg),
    )
    name, tris = ja._tri(jcfg)
    occ = j_pallas.occluded_clusters_pallas_streamed(
        tris, ja.aabb8, o_s, d_s, T_MIN, T_MAX, rays_per_tile=ja._rpt(jcfg),
        branch=2 * ja.super_branch, interpret=True, tri_test=name,
    )
    return np.asarray(back(occ))


@pytest.mark.parametrize(
    "which,route,sort_rays,tri_test",
    [
        ("scenes", "flat", "auto", "auto"),
        ("scenes", "flat", "off", "mt"),
        ("many", "hier", "auto", "auto"),
        ("many", "hier", "octant", "mt"),
        ("many", "streamed", "auto", "auto"),
        ("scenes", "streamed", "auto", "mt"),
    ],
)
def test_cluster_accel_occluded_matches_jax(request, monkeypatch, which, route, sort_rays, tri_test):
    """ClusterAccel.occluded (parking, sort, the route's any-hit kernel,
    restore) against the JAX accel through the Pallas kernels in
    interpret mode, with a third of the lanes inactive: flags equal on
    the active lanes."""
    j, t = request.getfixturevalue(which)
    monkeypatch.setenv("TPU_PT_PALLAS_INTERPRET", "1")
    if route == "streamed":
        monkeypatch.setattr(cluster_mod, "_FLAT_MAX_BYTES", 1024)
    cfg = RenderConfig(sort_rays=sort_rays, tri_test=tri_test, intersector="cluster")
    jcfg = JConfig(sort_rays=sort_rays, tri_test=tri_test, intersector="cluster")
    assert t.accel.route(cfg) == route
    o, d = random_rays(26, 3000)
    active = np.random.RandomState(27).rand(3000) < 0.67
    if route == "streamed":
        want = jax_occluded_streamed(j.accel, o, d, jnp.asarray(active), jcfg)
    else:
        want = np.asarray(j.accel.occluded(j.vertices, jnp.asarray(o), jnp.asarray(d), T_MIN, T_MAX, jcfg,
                                           active=jnp.asarray(active)))
    got = t.accel.occluded(t.vertices, torch.as_tensor(o), torch.as_tensor(d), T_MIN, T_MAX, cfg,
                           active=torch.as_tensor(active)).numpy()
    np.testing.assert_array_equal(got[active], want[active])
    assert 300 < got[active].sum() < active.sum() - 300


def test_occluded_scene_routes(scenes):
    """occluded_scene takes brute force without an accel and the accel's
    any-hit with one; both agree on the active lanes."""
    _, t = scenes
    o, d = (torch.as_tensor(x) for x in random_rays(28, 500))
    active = torch.as_tensor(np.random.RandomState(29).rand(500) < 0.5)
    cfg = RenderConfig(intersector="auto")
    acc = isect.occluded_scene(t, o, d, T_MIN, T_MAX, cfg, active=active)
    brute = isect.occluded_scene(t.replace(accel=None), o, d, T_MIN, T_MAX, cfg, active=active)
    assert torch.equal(acc[active], brute[active])
    assert torch.equal(brute, isect.occluded_brute(t.vertices, o, d, T_MIN, T_MAX))
    with pytest.raises(ValueError):
        isect.occluded_scene(t.replace(accel=None), o, d, T_MIN, T_MAX, RenderConfig(intersector="cluster"))


@pytest.mark.parametrize("route", ["flat", "hier", "streamed"])
def test_occluded_cuda_wrappers_refuse_cpu_tensors(scenes, many, route):
    """No any-hit kernel entry falls back to its plain version."""
    ta = (scenes if route == "flat" else many)[1].accel
    o, d = (torch.as_tensor(x) for x in random_rays(30, 32))
    with pytest.raises(ValueError, match="CUDA"):
        if route == "flat":
            ic.occluded_clusters_cuda(ta.tris16bw, ta.aabb8, ta.order, o, d, T_MIN, T_MAX, RPT)
        elif route == "hier":
            ic.occluded_clusters_hier_cuda(ta.tris16bw, ta.aabb8_child, ta.aabb8_super, ta.order_super,
                                           o, d, T_MIN, T_MAX, RPT_HIER, 8)
        else:
            ic.occluded_clusters_streamed_cuda(ta.tris16bw, *ic.streamed_pads(ta.aabb8), o, d,
                                               T_MIN, T_MAX, RPT_HIER, 16)


def test_plain_occluded_counts_work(scenes):
    """The plain any-hit version counts the ray-triangle tests its kernel
    makes: a ray not yet occluded tests a visited cluster's triangles up
    to its first hit, so fewer than the closest hit's, which tests them
    all, on the same rays."""
    _, t = scenes
    ta = t.accel
    o, d = (torch.as_tensor(x) for x in random_rays(31, 2000))
    any_hit, closest = {}, {}
    ic.occluded_clusters_plain(ta.tris16bw, ta.aabb8, ta.order, o, d, T_MIN, T_MAX, RPT, stats=any_hit)
    ic.intersect_clusters_plain(ta.tris16bw, ta.aabb8, ta.order, o, d, T_MIN, T_MAX, RPT, stats=closest)
    assert 0 < any_hit["tests"] < closest["tests"]
    assert closest["tests"] == closest["visits"] * RPT * ta.cluster_size
    assert 0 < any_hit["visits"] <= closest["visits"]
