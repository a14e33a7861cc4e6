"""The port's ray ordering (ops/ray_sort.py: the int32 sort key with the
shadow rays' parking, the sort and gather, the restore into a Hit, the
packet order) against the JAX package on the CPU: the key against
`ray_sort_key`, the sorted rays against `octant_sort`, the restore
against the JAX accel's packed restore, the packet order's rank formula
against a stable descending argsort, and `ClusterAccel.occluded` with a
mask against the JAX accel through the Pallas kernels in interpret mode.
The CUDA kernels are held to these plain versions on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.accel.build import build_accel as j_build_accel  # noqa: E402
from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402
from tpu_pathtracer.ops import intersect_pallas as j_pallas  # noqa: E402
from tpu_pathtracer.scene import procedural as j_proc  # noqa: E402

from tpu_pathtracer_torch.accel.build import build_accel  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops import intersect_cluster as ic  # noqa: E402
from tpu_pathtracer_torch.ops import ray_sort  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402

T_MIN, T_MAX = 0.01, 1e16
# (spatial bits, direction bits) of the key: octant only, octant with
# direction bits, the accel's two spatial defaults, the widest key
KEY_BITS = [(0, 0), (0, 2), (7, 2), (5, 3), (9, 4)]


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port scene): three spheres, 1730 triangles in 14
    clusters of 128 (the flat route)."""
    j = j_build_accel(j_proc.three_spheres_scene(12, 24), kind="cluster")
    t = build_accel(procedural.three_spheres_scene(12, 24, device="cpu"))
    return j, t


@pytest.fixture(scope="module")
def many():
    """(JAX scene, port scene): three spheres (8, 16) in 97 clusters of 8,
    the two-level route."""
    j = j_build_accel(j_proc.three_spheres_scene(8, 16), kind="cluster", cluster_size=8)
    t = build_accel(procedural.three_spheres_scene(8, 16, device="cpu"), cluster_size=8)
    return j, t


def random_rays(seed, n):
    """Rays from around the scene toward random points on it, a quarter in
    random directions, the first 100 sharing one origin (as primary rays
    share a cell); and a mask over about two thirds of them."""
    rs = np.random.RandomState(seed)
    o = (rs.randn(n, 3) * np.array([5.0, 2.0, 5.0]) + np.array([0.0, 2.5, 0.0])).astype(np.float32)
    target = (rs.rand(n, 3) * np.array([8.0, 2.0, 2.0]) - np.array([4.0, 0.0, 1.0])).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[: n // 4] = rs.randn(n // 4, 3).astype(np.float32)
    o[:100] = o[0]
    return o, d, rs.rand(n) < 0.67


def jax_park(ja, o, d, active):
    """The JAX accel's parking (tpu_pathtracer/accel/cluster.py, occluded)."""
    park = ja.scene_hi + (ja.scene_hi - ja.scene_lo) + 1.0
    return (jnp.where(active[:, None], jnp.asarray(o), park[None, :]),
            jnp.where(active[:, None], jnp.asarray(d), jnp.array([1.0, 0.0, 0.0], jnp.float32)))


@pytest.mark.parametrize("masked", [False, True], ids=["all", "active"])
@pytest.mark.parametrize("spatial_bits,dir_bits", KEY_BITS)
def test_sort_key_matches_jax(scenes, spatial_bits, dir_bits, masked):
    """The plain sort key, an int32, equals JAX's u32 ray_sort_key value for
    value; with a mask, on the rays JAX parks."""
    j, t = scenes
    o, d, active = random_rays(0, 5000)
    jo, jd = jax_park(j.accel, o, d, jnp.asarray(active)) if masked else (jnp.asarray(o), jnp.asarray(d))
    want = np.asarray(j_pallas.ray_sort_key(jo, jd, j.accel.scene_lo, j.accel.scene_hi, spatial_bits, dir_bits))
    got = ray_sort.sort_key_plain(torch.as_tensor(o), torch.as_tensor(d), t.accel.scene_lo, t.accel.scene_hi,
                            spatial_bits, dir_bits, active=torch.as_tensor(active) if masked else None)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
    assert len(np.unique(want)) > (1 if spatial_bits + dir_bits == 0 else 8)


@pytest.mark.parametrize("spatial_bits", range(10))
def test_largest_key_fits_int32(scenes, spatial_bits):
    """For every allowed (sort_spatial_bits, sort_dir_bits) (config.py: 0-9
    and up to 4), the largest key, every bit set (an origin in the last
    cell, a direction with every component positive and of magnitude 1),
    equals JAX's and stays below 2^31."""
    j, t = scenes
    lo, hi = t.accel.scene_lo, t.accel.scene_hi
    o = hi[None, :] + 1.0
    d = torch.ones((1, 3))
    for dir_bits in range(5):
        width = 3 + 3 * spatial_bits + 3 * ray_sort.key_dir_bits(spatial_bits, dir_bits)
        got = int(ray_sort.sort_key_plain(o, d, lo, hi, spatial_bits, dir_bits)[0])
        want = int(j_pallas.ray_sort_key(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), j.accel.scene_lo,
                                         j.accel.scene_hi, spatial_bits, dir_bits)[0])
        assert got == want == (1 << width) - 1 and width <= 30
        assert got < 2**31


@pytest.mark.parametrize("masked", [False, True], ids=["all", "active"])
@pytest.mark.parametrize("mode,spatial_bits,dir_bits", [("octant", 0, 2), ("spatial", 0, 0), ("spatial", 5, 3),
                                                        ("spatial", 9, 4)])
def test_sorted_rays_match_jax_octant_sort(scenes, mode, spatial_bits, dir_bits, masked):
    """ClusterAccel.sort (on the CPU sort_rays' plain version: the key,
    torch.sort on the int32 key, the gather; the parking with a mask)
    against the JAX accel's sort of the rays it parks (octant_sort): the
    permutation and the sorted rays exactly."""
    j, t = scenes
    o, d, active = random_rays(1, 5000)
    kw = dict(sort_rays=mode, sort_spatial_bits=spatial_bits, sort_dir_bits=dir_bits)
    jo, jd = jax_park(j.accel, o, d, jnp.asarray(active)) if masked else (jnp.asarray(o), jnp.asarray(d))
    o_j, d_j, restore_j = j.accel._sorted_rays(mode, jo, jd, JConfig(**kw))
    perm_j = np.argsort(np.asarray(restore_j(jnp.arange(5000))))  # restore gathers through the inverse
    o_t, d_t, perm = t.accel.sort(torch.as_tensor(o), torch.as_tensor(d), RenderConfig(**kw),
                                  active=torch.as_tensor(active) if masked else None)
    np.testing.assert_array_equal(perm.numpy(), perm_j)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


@pytest.mark.parametrize("masked", [False, True], ids=["all", "active"])
@pytest.mark.parametrize("spatial_bits,dir_bits", KEY_BITS)
def test_sort_rays_plain_matches_jax_sort_by_key(scenes, spatial_bits, dir_bits, masked):
    """sort_rays_plain, the plain version the radix sort kernel is held to,
    against JAX's sort_by_key (lax.sort_key_val) of ray_sort_key on the
    rays JAX parks: the permutation and the sorted rays exactly, with
    ties (the first 100 rays share one origin; parked lanes share one
    key)."""
    j, t = scenes
    o, d, active = random_rays(6, 5000)
    jo, jd = jax_park(j.accel, o, d, jnp.asarray(active)) if masked else (jnp.asarray(o), jnp.asarray(d))
    key = j_pallas.ray_sort_key(jo, jd, j.accel.scene_lo, j.accel.scene_hi, spatial_bits, dir_bits)
    o_j, d_j, restore_j = j_pallas.sort_by_key(jo, jd, key)
    perm_j = np.argsort(np.asarray(restore_j(jnp.arange(5000))))
    o_t, d_t, perm = ray_sort.sort_rays_plain(torch.as_tensor(o), torch.as_tensor(d), t.accel.scene_lo,
                                              t.accel.scene_hi, spatial_bits, dir_bits,
                                              torch.as_tensor(active) if masked else None)
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), perm_j)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def jax_packed_restore(restore_j, best_t, best_prim, bary):
    """The JAX accel's restore of a sorted closest hit (accel/cluster.py,
    intersect): prim as an exact float in one packed row, one gather."""
    primf = jnp.where(best_prim == jnp.int32(0x7FFFFFFF), jnp.float32(-1.0), best_prim.astype(jnp.float32))
    packed = restore_j(jnp.concatenate([best_t[:, None], primf[:, None], bary], axis=-1))
    prim = packed[:, 1].astype(jnp.int32)
    hit = prim >= 0
    return packed[:, 0], jnp.where(hit, prim, -1), jnp.where(hit[:, None], packed[:, 2:4], 0.0), hit


def jax_unsorted_hit(best_t, best_prim, bary):
    """The JAX accel's Hit of an unsorted closest hit."""
    hit = best_prim < jnp.int32(0x7FFFFFFF)
    return best_t, jnp.where(hit, best_prim, -1), jnp.where(hit[:, None], bary, 0.0), hit


@pytest.mark.parametrize("sorted_", [True, False], ids=["perm", "identity"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_restore_hits_matches_jax(scenes, any_hit, sorted_):
    """restore_hits_plain against the JAX accel's restore (the packed
    row through sort_by_key's restore, then the Hit; any hit: the flags
    through the same restore), with a third of the lanes missing, through
    a permutation of a real sort key and without one.  The restore does no
    arithmetic, so t and bary are held exactly: within assert_close_fma's
    rule (test_torch_intersect.py) at its tightest."""
    j, t = scenes
    n = 4000
    o, d, _ = random_rays(2, n)
    rs = np.random.RandomState(3)
    best_t = rs.rand(n).astype(np.float32) * 10
    best_prim = rs.randint(0, 1730, n).astype(np.int32)
    best_prim[rs.rand(n) < 0.33] = 0x7FFFFFFF
    bary = rs.rand(n, 2).astype(np.float32)
    occ = rs.rand(n) < 0.4
    key = j_pallas.ray_sort_key(jnp.asarray(o), jnp.asarray(d), j.accel.scene_lo, j.accel.scene_hi, 7, 2)
    _, _, restore_j = j_pallas.sort_by_key(jnp.asarray(o), jnp.asarray(d), key)
    perm = None
    if sorted_:
        perm = torch.sort(ray_sort.sort_key_plain(torch.as_tensor(o), torch.as_tensor(d), t.accel.scene_lo,
                                            t.accel.scene_hi, 7, 2), stable=True).indices
    if any_hit:
        want = np.asarray(restore_j(jnp.asarray(occ))) if sorted_ else occ
        got = ray_sort.restore_hits_plain(torch.as_tensor(occ), perm)
        np.testing.assert_array_equal(got.numpy(), want)
        return
    sorted_out = (jnp.asarray(best_t), jnp.asarray(best_prim), jnp.asarray(bary))
    want = jax_packed_restore(restore_j, *sorted_out) if sorted_ else jax_unsorted_hit(*sorted_out)
    got = ray_sort.restore_hits_plain(tuple(torch.as_tensor(x) for x in (best_t, best_prim, bary)), perm)
    for name, w in zip(("t", "prim", "bary", "hit"), want):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(w), err_msg=name)
    assert 0 < int(got.hit.sum()) < n


def rank_order(w):
    """The packet-order kernel's rule (csrc/ray_sort.cu): each packet's
    rank counted over the weights a chunk of 4,096 at a time,
    rank_i = #{j : w_j > w_i} + #{j < i : w_j == w_i}, then
    order[rank_i] = i."""
    p = len(w)
    idx = np.arange(p)
    rank = np.zeros(p, np.int64)
    for base in range(0, p, 4096):
        wj, j = w[base:base + 4096], idx[base:base + 4096]
        rank += ((wj[None, :] > w[:, None]) | ((wj[None, :] == w[:, None]) & (j[None, :] < idx[:, None]))).sum(1)
    order = np.empty(p, np.int32)
    order[rank] = idx
    return order


@pytest.mark.parametrize("ties", ["many", "few"])
@pytest.mark.parametrize("packets", [1, 128, 4096, 5000])
def test_packet_order_rank_formula(packets, ties):
    """The packet order's rank formula equals torch.argsort(descending,
    stable) (the plain version, which the CPU runs) on weights with many
    ties and with few, at 1, 128 and 4,096 packets and past one chunk."""
    rs = np.random.RandomState(packets)
    w = rs.randint(0, 3 if ties == "many" else 1 << 20, packets).astype(np.int32)
    want = torch.argsort(torch.as_tensor(w), descending=True, stable=True).to(torch.int32)
    np.testing.assert_array_equal(rank_order(w), want.numpy())
    got = ray_sort.packet_order(torch.as_tensor(w))
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("share", [0.0, 0.35, 1.0], ids=["none", "some", "all"])
@pytest.mark.parametrize("which,route", [("scenes", "flat"), ("many", "hier")])
def test_cluster_accel_occluded_masked_matches_jax(request, monkeypatch, which, route, share):
    """ClusterAccel.occluded with an active mask (the key's parking, the
    sort, the route's any-hit traversal, the restore) against the JAX
    accel through the Pallas kernels in interpret mode, with no lane, a
    third of the lanes and every lane inactive: the flags equal on the
    active lanes."""
    j, t = request.getfixturevalue(which)
    monkeypatch.setenv("TPU_PT_PALLAS_INTERPRET", "1")
    cfg, jcfg = RenderConfig(intersector="cluster"), JConfig(intersector="cluster")
    assert t.accel.route(cfg) == route
    o, d, _ = random_rays(4, 2000)
    active = np.random.RandomState(5).rand(2000) >= share
    want = np.asarray(j.accel.occluded(j.vertices, jnp.asarray(o), jnp.asarray(d), T_MIN, T_MAX, jcfg,
                                       active=jnp.asarray(active)))
    got = t.accel.occluded(t.vertices, torch.as_tensor(o), torch.as_tensor(d), T_MIN, T_MAX, cfg,
                           active=torch.as_tensor(active)).numpy()
    np.testing.assert_array_equal(got[active], want[active])
    if share < 1.0:
        assert 100 < got[active].sum() < active.sum() - 100


@pytest.mark.parametrize("kernel", ["sort_rays", "sort_rays_masked", "restore_hits", "packet_order"])
def test_cuda_entries_refuse_cpu_tensors(scenes, kernel):
    """No ray-order kernel entry falls back to its plain version; the
    restore is the traversal kernel's store, through perm."""
    o, d = torch.zeros((4, 3)), torch.ones((4, 3))
    perm = torch.arange(4)
    acc = scenes[1].accel
    call = dict(sort_rays=lambda: ray_sort.sort_rays_cuda(o, d, o[0], d[0], 7, 2),
                sort_rays_masked=lambda: ray_sort.sort_rays_cuda(o, d, o[0], d[0], 0, 2, torch.ones(4, dtype=bool)),
                restore_hits=lambda: ic.intersect_clusters_cuda(acc.tris16bw, acc.aabb8, acc.order, o, d, T_MIN, T_MAX,
                                                                1024, restore=True, perm=perm),
                packet_order=lambda: ray_sort.packet_order_cuda(perm.int()))[kernel]
    with pytest.raises(ValueError, match="CUDA"):
        call()


@pytest.mark.parametrize("n", [2**23 - 1, 2**23, 35_251_200, 2**31 - 1])
def test_sort_rays_takes_every_batch_an_int32_index_reaches(n):
    """The sort kernel's status words are 64-bit above 2^23 - 1 keys, so
    its entry takes any batch up to 2^31 - 1 rays (a 1-spp DCI-4K frame's
    8,847,360; 1080p at 17 spp, 35,251,200) and stops only at the check
    that its tensors lie on a CUDA device."""
    o = torch.zeros((1, 3)).expand(n, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ray_sort.sort_rays_cuda(o, o, o[0], o[0], 7, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ray_sort.sort_rays_cuda(o, o, o[0], o[0], 0, 2, torch.ones(1, dtype=torch.bool).expand(n))


def test_sort_rays_refuses_more_rays_than_an_int32_index():
    """Past 2^31 - 1 rays the entry refuses the batch, naming the int32
    index, before it touches a device."""
    n = ray_sort.MAX_RAYS + 1
    o = torch.zeros((1, 3)).expand(n, 3)
    with pytest.raises(ValueError, match=r"rays: .*int32: at most 2147483647 \(2\^31 - 1\), got 2147483648"):
        ray_sort.sort_rays_cuda(o, o, o[0], o[0], 7, 2)
