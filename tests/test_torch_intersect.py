"""The PyTorch port's intersectors against the JAX package: the coherence
sort key and permutation, the cluster packet traversal (plain version vs
the Pallas kernel in interpret mode), ClusterAccel.intersect and brute
force.  The CUDA kernel is compared with its plain version on the card by
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

from tpu_pathtracer_torch.accel.build import build_accel  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops import intersect as isect  # noqa: E402
from tpu_pathtracer_torch.ops import intersect_cluster as ic  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402

T_MIN, T_MAX = 0.01, 1e16
RPT = 1024  # the JAX accel's rays per packet on flat-kernel scenes


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
    t = build_accel(procedural.three_spheres_scene(12, 24))
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
    got = ic.ray_sort_key(
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
    o_t, d_t, perm = ic.octant_sort(
        torch.as_tensor(o), torch.as_tensor(d), t.accel.scene_lo, t.accel.scene_hi, 7, 2
    )
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    back = ic.restore(o_t, perm)
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


@pytest.mark.parametrize(
    "cfg,what",
    [
        (dict(tri_test="mt"), "tri_test"),
        (dict(hier_min_clusters=8), "two-level"),
    ],
)
def test_unported_kernel_routes_raise(scenes, cfg, what):
    _, t = scenes
    o, d = random_rays(7, 64)
    with pytest.raises(NotImplementedError, match=what):
        t.accel.intersect(t.vertices, torch.as_tensor(o), torch.as_tensor(d), T_MIN, T_MAX, RenderConfig(**cfg))


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
