"""The design of the bounce kernel and of the traversal's store, on the CPU.

* Without NEE no field of a miss lane's bounce reads the shade, which
  reads triangle row 0 for it.  Held on the plain version,
  `_bounce_plain`: with row 0, its material and the texture pool
  perturbed, every miss lane's outputs keep their bits while hit lanes
  change, in each environment mode and both texture layouts.  Under NEE a
  miss lane's shade is read, and the test names the fields that read it.
  (The bounce kernel, csrc/bounce.cu, shades every lane all the same: a
  miss lane left out gained nothing on the pools a render feeds it.)
* The traversal kernels write their outputs in caller order through the
  sort's permutation (the restore, folded into their store): the route
  wrappers with `restore=True` on every route, closest and any hit, with
  no permutation, a sorted one and a masked one, on a ray count that is
  no multiple of the packet, against the JAX package on the same rays
  (its accel's `intersect` and `occluded`, or its streamed kernels, the
  Pallas kernels in interpret mode).

The kernels against these plain versions, bit for bit:
tests/test_torch_cuda.py on a card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.accel.build import build_accel as j_build_accel  # noqa: E402
from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402
from tpu_pathtracer.ops import intersect_pallas as j_pallas  # noqa: E402
from tpu_pathtracer.scene import procedural as j_proc  # noqa: E402

from _torch_scenes import shade_rays, shade_scene  # noqa: E402
from test_torch_intersect import assert_close_fma, random_rays  # noqa: E402
from tpu_pathtracer_torch.accel import cluster as cluster_mod  # noqa: E402
from tpu_pathtracer_torch.accel.build import build_accel  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops import intersect as isect  # noqa: E402
from tpu_pathtracer_torch.ops import intersect_cluster as ic  # noqa: E402
from tpu_pathtracer_torch.ops.intersect import intersect_scene  # noqa: E402
from tpu_pathtracer_torch.render import integrator  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402

T_MIN, T_MAX = 0.01, 1e16
NEE = dict(env_mode="equirect", rr_mode="standard", env_importance_sampling=True)
PAYLOAD = ("radiance", "attenuation", "origin", "direction", "done", "seeds")


def same_bits(a, b):
    a, b = a.contiguous(), b.contiguous()
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


# ---------------------------------------------------------------------------
# The bounce: what a miss lane reads of the shade
# ---------------------------------------------------------------------------

def bounce_args(layout, cfg, n=1600):
    """shade_scene's scene, and one bounce's seeded inputs on shade_rays:
    the brute-force hits, attenuation in [0.2, 1.2), radiance in [0, 0.5),
    seeds, depth 0 on a tenth of the lanes, NEE's env credit."""
    scene = shade_scene(layout, "cpu")
    o, d = shade_rays(n, 31, "cpu")
    hit = intersect_scene(scene, o, d, cfg.t_min, cfg.t_max, cfg)
    rs = np.random.RandomState(32)
    att = torch.as_tensor((rs.rand(n, 3) + 0.2).astype(np.float32))
    rad = torch.as_tensor((rs.rand(n, 3) * 0.5).astype(np.float32))
    seeds = torch.as_tensor(rs.randint(1, 2**32, size=n, dtype=np.uint64).astype(np.int64))
    depth = torch.as_tensor(np.where(rs.rand(n) < 0.1, 0, 8).astype(np.int32))
    spec = None
    if cfg.env_importance_sampling:
        spec = torch.as_tensor(rs.rand(n).astype(np.float32)) if cfg.nee_mis_spec else torch.as_tensor(rs.rand(n) < 0.5)
    return scene, cfg, hit, o, d, att, rad, seeds, depth, spec


def perturbed(scene):
    """The scene with what a miss lane's shade reads changed: triangle row
    0 (vertices, normals, uvs), its material's row and every texel of both
    texture pools."""
    rs = np.random.RandomState(33)
    tri = scene.tri_attrs.clone()
    tri[0, :24] += torch.as_tensor(rs.rand(24).astype(np.float32) * 0.5 + 0.1)
    m = scene.materials
    mat = int(tri[0, 24])
    attrs = m.attrs.clone()
    attrs[mat, 0:3] = torch.as_tensor(rs.rand(3).astype(np.float32))
    attrs[mat, 9:11] = torch.as_tensor(rs.rand(2).astype(np.float32) * 0.5 + 0.2)
    def flip(x):
        return x ^ torch.as_tensor(rs.randint(1, 2**32, size=tuple(x.shape), dtype=np.uint64).astype(np.int64))

    mats = dataclasses.replace(m, attrs=attrs, texture_quads=flip(m.texture_quads),
                               texture_bundles=flip(m.texture_bundles))
    return scene.replace(tri_attrs=tri, materials=mats)


@pytest.mark.parametrize("layout", ["bundled_scrambled", "unbundled"])
@pytest.mark.parametrize("env_mode", ["equirect", "sunsky", "constant"])
def test_miss_lanes_read_no_shade_without_nee(layout, env_mode):
    """Without NEE a miss lane's payload is the miss program's radiance,
    its own attenuation, origin and direction, done and its seed: the same
    bits whatever row 0, its material and the textures hold, while lanes
    that hit change with them."""
    cfg = RenderConfig(env_mode=env_mode, max_depth=8, dof=False, intersector="brute")
    args = bounce_args(layout, cfg)
    hit = args[2].hit
    assert 200 < int(hit.sum()) < hit.shape[0] - 200
    want = integrator._bounce_plain(*args)
    got = integrator._bounce_plain(perturbed(args[0]), *args[1:])
    for k in PAYLOAD:
        assert same_bits(got[k][~hit], want[k][~hit]), k
    assert not all(same_bits(got[k][hit], want[k][hit]) for k in PAYLOAD)
    assert not same_bits(got["origin"][hit], args[3][hit])


# Under NEE: the fields a miss lane's bounce writes that read its shade of
# row 0, by NEE option (the NEE record's floats, the light draw, and the
# next segment's env credit), and those that do not.
NEE_MISS_READS = ("normal", "alpha", "spec_prob", "idotn", "brdf_combined", "f_vec", "diffuse_albedo", "spec_dir",
                  "spec_pdf", "cos_l", "spec_last")
NEE_MISS_READS_DEFENSIVE = NEE_MISS_READS + ("shadow_dir", "pdf", "u", "v")
NEE_MISS_KEEPS = PAYLOAD + ("shadow_origin", "cand")


def nee_fields(args):
    """Every field the bounce kernel writes under NEE, from its plain
    pieces: _bounce_plain's payload and env credit, _shade's record
    fields, _light_sample's draw and _shadow_candidates'."""
    scene, cfg, hit, o, d, att, rad, seeds, depth, spec = args
    out = integrator._bounce_plain(*args)
    sh = integrator._shade(scene, cfg, hit, o, d, seeds, depth)
    _, env_dir, pdf, u, v = integrator._light_sample(scene, cfg, sh, sh["seeds"])
    cand, cos_l = integrator._shadow_candidates(hit.hit, sh, env_dir)
    fields = {k: out[k] for k in PAYLOAD + ("spec_last",)}
    fields.update({k: sh[k] for k in NEE_MISS_READS[:9]})
    fields.update(shadow_origin=sh["new_origin"], shadow_dir=env_dir, cand=cand, pdf=pdf, u=u, v=v, cos_l=cos_l)
    return fields


@pytest.mark.parametrize("layout", ["bundled_scrambled", "unbundled"])
@pytest.mark.parametrize("option", ["nee", "mis_defensive"])
def test_nee_miss_lanes_read_row_zero(layout, option):
    """Under NEE a miss lane's shade of row 0 is read: the NEE record, the
    light draw's cosine (under the defensive mixture the draw itself) and
    the next segment's env credit change with row 0 on miss lanes, so the
    kernel shades every lane there; the payload, the shadow origin and
    the candidate flag do not."""
    extra = dict(nee_mis_spec=True, nee_defensive_mix=True) if option == "mis_defensive" else {}
    from tpu_pathtracer_torch.render.envmap import with_importance_sampling

    cfg = RenderConfig(**NEE, **extra, max_depth=8, dof=False, intersector="brute")
    args = bounce_args(layout, cfg)
    args = (args[0].replace(env=with_importance_sampling(args[0].env)),) + args[1:]
    miss = ~args[2].hit
    want = nee_fields(args)
    got = nee_fields((perturbed(args[0]),) + args[1:])
    reads = NEE_MISS_READS_DEFENSIVE if option == "mis_defensive" else NEE_MISS_READS
    assert sorted(reads + NEE_MISS_KEEPS) == sorted(set(reads + NEE_MISS_KEEPS) & set(want))
    for k in reads:
        assert not same_bits(got[k][miss], want[k][miss]), k
    for k in NEE_MISS_KEEPS:
        assert same_bits(got[k][miss], want[k][miss]), k


# ---------------------------------------------------------------------------
# The traversal's store: the restore into caller order
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def many():
    """(JAX scene, port scene): three spheres (8, 16) in 97 clusters of 8,
    the two-level route; its flat and streamed walks run on it too."""
    j = j_build_accel(j_proc.three_spheres_scene(8, 16), kind="cluster", cluster_size=8)
    t = build_accel(procedural.three_spheres_scene(8, 16, device="cpu"), cluster_size=8)
    return j, t


RPT = 64
WRAPPERS = {("flat", False): ic.intersect_clusters, ("hier", False): ic.intersect_clusters_hier,
            ("streamed", False): ic.intersect_clusters_streamed, ("flat", True): ic.occluded_clusters,
            ("hier", True): ic.occluded_clusters_hier, ("streamed", True): ic.occluded_clusters_streamed}


def test_wrappers_refuse_perm_without_restore(many):
    acc = many[1].accel
    o, d = (torch.as_tensor(x) for x in random_rays(43, 64))
    with pytest.raises(ValueError, match="restore"):
        ic.intersect_clusters_cuda(acc.tris16bw, acc.aabb8, acc.order, o, d, T_MIN, T_MAX, RPT,
                                   perm=torch.arange(64))


SORT_MODES = {"flat": "auto", "hier": "octant", "streamed": "auto"}


def jax_reference(j, route, any_hit, o_np, d_np, active_np, jcfg):
    """The JAX package's answer in caller order: its accel's intersect or
    occluded (the Pallas kernels in interpret mode); on the streamed route,
    whose 6 MB line the JAX accel fixes, its streamed kernel on the rays
    as given."""
    ja = j.accel
    o, d = jnp.asarray(o_np), jnp.asarray(d_np)
    if route != "streamed":
        if any_hit:
            return np.asarray(ja.occluded(j.vertices, o, d, T_MIN, T_MAX, jcfg, active=jnp.asarray(active_np)))
        return ja.intersect(j.vertices, o, d, T_MIN, T_MAX, jcfg)
    name, tris = ja._tri(jcfg)
    kw = dict(rays_per_tile=ja._rpt(jcfg), branch=2 * ja.super_branch, interpret=True, tri_test=name)
    if any_hit:
        return np.asarray(j_pallas.occluded_clusters_pallas_streamed(tris, ja.aabb8, o, d, T_MIN, T_MAX, **kw))
    bt, bp, buv = (np.asarray(x) for x in j_pallas.intersect_clusters_pallas_streamed(
        tris, ja.aabb8, o, d, T_MIN, T_MAX, **kw))
    hit = bp != ic.MISS_PRIM
    return isect.Hit(t=bt, prim=np.where(hit, bp, -1), bary=np.where(hit[:, None], buv, 0.0), hit=hit)


@pytest.mark.parametrize("order", ["none", "sorted", "masked"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("route", ["flat", "hier", "streamed"])
def test_wrappers_restore_match_jax_accel(many, monkeypatch, route, any_hit, order):
    """A route wrapper with restore=True, on the rays the port's sort gives
    it, against the JAX package on the same rays in caller order: the Hit
    (prim -1 and bary 0 on a miss) within the port's rule against XLA's
    contractions, or the flags exactly, row i at perm[i]; with no sort
    (perm None) the identity.  With a mask the parked lanes are compared
    as parked (a miss, not occluded), the others with the reference.
    1,500 rays in packets of 512 or less: the last packet is ragged."""
    monkeypatch.setenv("TPU_PT_PALLAS_INTERPRET", "1")
    if route == "streamed":
        monkeypatch.setattr(cluster_mod, "_FLAT_MAX_BYTES", 1024)
    j, t = many
    kw = dict(sort_rays="off" if order == "none" else SORT_MODES[route], intersector="cluster",
              hier_min_clusters=96 if route == "hier" else 1000)
    cfg, jcfg = RenderConfig(**kw), JConfig(**kw)
    acc = t.accel
    assert acc.route(cfg) == route
    o_np, d_np = random_rays(44, 1500, parked=60)
    masked = order == "masked"
    active_np = np.random.RandomState(45).rand(1500) < 0.6 if masked else np.ones(1500, bool)
    o, d = torch.as_tensor(o_np), torch.as_tensor(d_np)
    o_s, d_s, perm = acc.sort(o, d, cfg, torch.as_tensor(active_np) if masked else None)
    assert (perm is None) == (order == "none")
    if perm is not None:
        assert not torch.equal(perm, torch.arange(1500))
    _, args = acc.traversal(o_s, d_s, T_MIN, T_MAX, cfg)
    assert 1500 % args[-2 if route == "flat" else -3] != 0
    got = WRAPPERS[route, any_hit](*args, restore=True, perm=perm)
    want = jax_reference(j, route, any_hit, o_np, d_np, active_np, jcfg)
    on = active_np
    if any_hit:
        np.testing.assert_array_equal(got.numpy()[on], want[on])
        assert not got.numpy()[~on].any()
        assert 50 < int(want[on].sum()) < int(on.sum()) - 50
        return
    assert not got.hit.numpy()[~on].any() and (got.prim.numpy()[~on] == -1).all()
    assert not got.bary.numpy()[~on].any()
    np.testing.assert_array_equal(got.prim.numpy()[on], np.asarray(want.prim)[on])
    np.testing.assert_array_equal(got.hit.numpy()[on], np.asarray(want.hit)[on])
    assert 50 < int(got.hit.sum()) < int(on.sum()) - 50
    assert_close_fma(got.t.numpy()[on], np.asarray(want.t)[on], rtol=1e-6)
    # XLA:CPU's fused multiply-adds (assert_close_fma): on these rays one
    # bary of 1,500 is 1.4e-4 off where u = p1.h + c1 cancels
    assert_close_fma(got.bary.numpy()[on], np.asarray(want.bary)[on], atol=1e-5, loose=30.0)
