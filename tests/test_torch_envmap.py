"""The PyTorch port's environment importance sampling against the JAX
package: the CDF and Vose alias tables, the alias and CDF draws, their
densities, radiance fetched at a draw's (u, v), and the bridge carrying
the tables across."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402
from tpu_pathtracer.render import envmap as j_envmap  # noqa: E402
from tpu_pathtracer.scene import procedural as j_proc  # noqa: E402
from tpu_pathtracer.scene import scene as j_scene  # noqa: E402
from tpu_pathtracer.utils.image import procedural_hdr  # noqa: E402

from test_torch_intersect import assert_close_fma  # noqa: E402
from test_torch_scene import jax_scene_leaves  # noqa: E402
from tpu_pathtracer_torch.bridge import scene_from_numpy  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.render import envmap  # noqa: E402
from tpu_pathtracer_torch.scene import scene  # noqa: E402

# (height, width, sun intensity): a power-of-two map (scrambled quads), an
# odd-sized one, and a sun-heavy one whose alias table has long chains.
SHAPES = pytest.mark.parametrize("h,w,sun", [(32, 64, None), (12, 20, None), (16, 32, 500.0)],
                                 ids=["pow2", "odd", "sun_heavy"])


def envs(h, w, sun):
    kw = {} if sun is None else dict(sun_intensity=sun)
    hdr = procedural_hdr(h, w, seed=3, **kw)
    return (j_envmap.with_importance_sampling(j_scene.make_env(hdr)),
            envmap.with_importance_sampling(scene.make_env(hdr, "cpu")))


def uniforms(seed, n=20_000):
    rs = np.random.RandomState(seed)
    return [rs.rand(n).astype(np.float32) for _ in range(4)]


@SHAPES
def test_alias_table_bit_equal(h, w, sun):
    """Vose in numpy float64 on both sides: the same bits."""
    j, t = envs(h, w, sun)
    assert t.alias_table.shape == (h * w, 4) and t.alias_table.dtype == torch.float32
    np.testing.assert_array_equal(t.alias_table.numpy(), np.asarray(j.alias_table))


@SHAPES
def test_cdf_tables_match_jax(h, w, sun):
    """The marginal row CDF and the conditional column CDFs: float32 sums
    of the texel weights, which XLA:CPU adds in another order and with
    fused multiply-adds in the luminance, so they are not the same bits:
    to rtol 1e-6, and both end at 1.  (The NEE path draws from the alias
    table, which is bit-equal.)"""
    j, t = envs(h, w, sun)
    np.testing.assert_allclose(t.cdf_rows.numpy(), np.asarray(j.cdf_rows), rtol=1e-6, atol=0)
    np.testing.assert_allclose(t.cdf_cols.numpy(), np.asarray(j.cdf_cols), rtol=1e-6, atol=0)
    np.testing.assert_allclose(t.cdf_rows.numpy()[-1], 1.0, rtol=1e-6)
    np.testing.assert_allclose(t.cdf_cols.numpy()[:, -1], 1.0, rtol=1e-6)


@SHAPES
def test_sample_env_alias_matches_jax(h, w, sun):
    """The texel and (u, v) of every draw exactly; direction and pdf to
    rtol 1e-5 / atol 1e-6 (sin, cos and the Jacobian's cos in float32)."""
    j, t = envs(h, w, sun)
    us = uniforms(1)
    d_j, p_j, u_j, v_j = j_envmap.sample_env_alias(j.alias_table, h, w, *map(jnp.asarray, us))
    d_t, p_t, u_t, v_t = envmap.sample_env_alias(t.alias_table, h, w, *map(torch.as_tensor, us))
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5, atol=1e-6)


@SHAPES
def test_env_pdfs_match_jax(h, w, sun):
    """env_pdf_alias and env_pdf at arbitrary directions, poles and the
    seam included, to rtol 1e-5.  env_pdf_alias divides by the cosine of
    the elevation asin(y) gives, so within 3 degrees of a pole one ulp of
    asin grows: measured 5 of 5000 directions (|y| > 0.997) off by 2.04e-4
    relative.  So 99.5% within rtol 1e-5 and all within 3e-4."""
    j, t = envs(h, w, sun)
    rs = np.random.RandomState(2)
    d = rs.randn(5000, 3).astype(np.float32)
    d[:3] = [[0, 1, 0], [0, -1, 0], [1e-9, 0, -1]]
    got = envmap.env_pdf_alias(t.alias_table, h, w, torch.as_tensor(d)).numpy()
    want = np.asarray(j_envmap.env_pdf_alias(j.alias_table, h, w, jnp.asarray(d)))
    assert_close_fma(got, want, rtol=1e-5, atol=1e-6)
    got = envmap.env_pdf(t, torch.as_tensor(d)).numpy()
    want = np.asarray(j_envmap.env_pdf(j, jnp.asarray(d)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@SHAPES
def test_sample_env_cdf_matches_jax(h, w, sun):
    """The CDF sampler: the same texel for all but draws that land within
    a rounding of a CDF step (the CDFs agree to 1e-6, not in every bit),
    and there the direction and pdf to rtol 1e-5."""
    j, t = envs(h, w, sun)
    u1, u2, _, _ = uniforms(4)
    d_j, p_j = j_envmap.sample_env(j, jnp.asarray(u1), jnp.asarray(u2))
    d_t, p_t = envmap.sample_env(t, torch.as_tensor(u1), torch.as_tensor(u2))
    same = np.isclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-6).all(axis=1)
    assert same.mean() > 0.999, f"{(~same).sum()} draws took another texel"
    np.testing.assert_allclose(p_t.numpy()[same], np.asarray(p_j)[same], rtol=1e-5, atol=1e-6)


@SHAPES
def test_eval_env_at_draw_uv_matches_jax(h, w, sun):
    """eval_env(uv=...) fetches at the draw's own (u, v) as the JAX
    package does, and ignores `active`."""
    j, t = envs(h, w, sun)
    us = uniforms(5)
    d_j, _, u_j, v_j = j_envmap.sample_env_alias(j.alias_table, h, w, *map(jnp.asarray, us))
    d_t, _, u_t, v_t = envmap.sample_env_alias(t.alias_table, h, w, *map(torch.as_tensor, us))
    active = np.random.RandomState(6).rand(len(us[0])) < 0.5
    want = j_envmap.eval_env(j, d_j, JConfig(env_mode="equirect"), uv=(u_j, v_j))
    got = envmap.eval_env(t, d_t, RenderConfig(env_mode="equirect"), active=torch.as_tensor(active), uv=(u_t, v_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_uv_to_direction_matches_jax():
    rs = np.random.RandomState(7)
    u, v = rs.rand(2, 5000).astype(np.float32)
    want = j_envmap.uv_to_direction(jnp.asarray(u), jnp.asarray(v))
    got = envmap.uv_to_direction(torch.as_tensor(u), torch.as_tensor(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    back_u, back_v = envmap.direction_to_uv(got)
    inner = (v > 0.01) & (v < 0.99)
    np.testing.assert_allclose(back_v.numpy()[inner], v[inner], atol=1e-5)


def test_alias_draws_follow_the_texel_distribution():
    """The port's alias draws land on texels in proportion to luminance *
    sin(theta) (as tests/test_envmap.py checks the JAX sampler)."""
    h, w = 16, 32
    _, t = envs(h, w, None)
    us = uniforms(8, 200_000)
    _, pdf, u, v = envmap.sample_env_alias(t.alias_table, h, w, *map(torch.as_tensor, us))
    tx = np.clip((u.numpy() * w).astype(int), 0, w - 1)
    ty = np.clip((v.numpy() * h).astype(int), 0, h - 1)
    counts = np.bincount(ty * w + tx, minlength=h * w) / len(tx)
    weights, _ = envmap._texel_weights(t.data)
    p = (weights / weights.sum()).reshape(-1).numpy()
    assert np.abs(counts - p).sum() < 0.05
    assert (pdf > 0).all()
    # The mean of 1/pdf estimates the sphere's solid angle, 4 pi.
    assert abs(float((1.0 / pdf).mean()) - 4 * np.pi) < 0.05 * 4 * np.pi


def test_bridge_carries_the_tables():
    """A JAX scene whose environment has the importance-sampling tables
    crosses the bridge with them; one without them crosses without."""
    env = j_envmap.with_importance_sampling(j_scene.make_env(procedural_hdr(16, 32)))
    leaves = jax_scene_leaves(j_proc.single_sphere_scene(stacks=4, slices=8).replace(env=env))
    carried = scene_from_numpy(leaves, "cpu").env
    for name in ("cdf_rows", "cdf_cols", "alias_table"):
        np.testing.assert_array_equal(getattr(carried, name).numpy(), np.asarray(getattr(env, name)))
    leaves = jax_scene_leaves(j_proc.single_sphere_scene(stacks=4, slices=8))
    plain = scene_from_numpy(leaves, "cpu").env
    assert plain.alias_table is None and plain.cdf_rows is None
