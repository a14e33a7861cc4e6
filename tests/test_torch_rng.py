"""The PyTorch port's counter-based PCG RNG and vector math against the JAX
package: seeds bit for bit, including values near 2^32."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several worker processes: one intra-op thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.utils import math as j_vm  # noqa: E402
from tpu_pathtracer.utils import rng as j_rng  # noqa: E402

from tpu_pathtracer_torch.utils import math as vm  # noqa: E402
from tpu_pathtracer_torch.utils import rng  # noqa: E402

N = 100_000


def u32_values(seed=0, n=N):
    """n random u32 values, with the edges of the range (0, 1, 2^31-1,
    2^31 and the last 256 values below 2^32) at the front."""
    rs = np.random.RandomState(seed)
    edges = np.concatenate(
        [[0, 1, 2**31 - 1, 2**31], np.arange(2**32 - 256, 2**32)]
    ).astype(np.uint64)
    rand = rs.randint(0, 2**32, size=n - len(edges), dtype=np.uint64)
    return np.concatenate([edges, rand]).astype(np.uint32)


def t64(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def as_u32(x):
    return x.numpy().astype(np.uint32) if isinstance(x, torch.Tensor) else np.asarray(x)


def test_pcg_hash_bit_exact():
    x = u32_values()
    np.testing.assert_array_equal(as_u32(rng.pcg_hash(t64(x))), np.asarray(j_rng.pcg_hash(jnp.asarray(x))))


def test_make_seeds_bit_exact():
    p, s, f = u32_values(1), u32_values(2), u32_values(3)
    got = rng.make_seeds(t64(p), t64(s), t64(f))
    want = j_rng.make_seeds(jnp.asarray(p), jnp.asarray(s), jnp.asarray(f))
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))


def test_make_seeds_scalar_counters():
    pix = np.arange(5000, dtype=np.int32)
    got = rng.make_seeds(torch.as_tensor(pix), 7, 3)
    want = j_rng.make_seeds(jnp.asarray(pix), jnp.int32(7), jnp.int32(3))
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))


def test_uniform_bit_exact():
    """The u32 -> f32 step rounds like XLA's: values near 2^32 give 1.0."""
    x = u32_values(4)
    s_got, u_got = rng.uniform(t64(x))
    s_want, u_want = j_rng.uniform(jnp.asarray(x))
    np.testing.assert_array_equal(as_u32(s_got), np.asarray(s_want))
    np.testing.assert_array_equal(u_got.numpy().view(np.int32), np.asarray(u_want).view(np.int32))
    assert u_got.dtype == torch.float32


def test_uniform_rounds_to_one_near_two_pow_32():
    """Raw u32 -> f32 conversion: the last values below 2^32 round to 2^32."""
    top = np.arange(2**32 - 128, 2**32, dtype=np.uint64).astype(np.int64)
    conv = torch.as_tensor(top).to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(top.astype(np.uint32)).astype(jnp.float32))
    np.testing.assert_array_equal(conv, want)
    assert (conv == np.float32(2.0**32)).all()


@pytest.mark.parametrize("draws", [2, 3])
def test_uniform_n_bit_exact(draws):
    x = u32_values(5, 20_000)
    f_got = rng.uniform2 if draws == 2 else rng.uniform3
    f_want = j_rng.uniform2 if draws == 2 else j_rng.uniform3
    got = f_got(t64(x))
    want = f_want(jnp.asarray(x))
    np.testing.assert_array_equal(as_u32(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_random_in_unit_sphere_matches_jax():
    """Seeds exact (same number of rejection draws per lane), points equal."""
    x = u32_values(6, 20_000)
    s_got, p_got = rng.random_in_unit_sphere(t64(x))
    s_want, p_want = j_rng.random_in_unit_sphere(jnp.asarray(x))
    np.testing.assert_array_equal(as_u32(s_got), np.asarray(s_want))
    np.testing.assert_array_equal(p_got.numpy(), np.asarray(p_want))
    assert (np.sum(p_got.numpy() ** 2, axis=-1) < 1.0).all()


def test_cosine_sample_hemisphere_matches_jax():
    rs = np.random.RandomState(8)
    u1, u2 = rs.rand(2, 10_000).astype(np.float32)
    got = rng.cosine_sample_hemisphere(torch.as_tensor(u1), torch.as_tensor(u2))
    want = j_rng.cosine_sample_hemisphere(jnp.asarray(u1), jnp.asarray(u2))
    # sin/cos may differ by an ulp between XLA and PyTorch, and y =
    # sqrt(1 - x^2 - z^2) magnifies that near the horizon: atol 1e-5.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _vecs(seed, n=4096):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32)


@pytest.mark.parametrize(
    "name", ["dot", "normalize", "cross", "reflect", "faceforward", "onb", "refract"]
)
def test_vector_math_matches_jax(name):
    a, b = _vecs(9), _vecs(10)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if name == "dot":
        got, want = vm.dot(ta, tb), j_vm.dot(ja, jb)
    elif name == "normalize":
        got, want = vm.normalize(ta), j_vm.normalize(ja)
    elif name == "cross":
        got, want = vm.cross(ta, tb), j_vm.cross(ja, jb)
    elif name == "reflect":
        got, want = vm.reflect(ta, vm.normalize(tb)), j_vm.reflect(ja, j_vm.normalize(jb))
    elif name == "faceforward":
        got, want = vm.faceforward(ta, tb, ta), j_vm.faceforward(ja, jb, ja)
    elif name == "onb":
        got = torch.cat(vm.onb_from_normal(ta), dim=-1)
        want = jnp.concatenate(j_vm.onb_from_normal(ja), axis=-1)
    else:
        eta = np.abs(a[:, 0]) + 0.5
        got = vm.refract(vm.normalize(ta), vm.normalize(tb), torch.as_tensor(eta))[0]
        want = j_vm.refract(j_vm.normalize(ja), j_vm.normalize(jb), jnp.asarray(eta))[0]
    # Near total internal reflection sqrt(k) magnifies an ulp of k: atol
    # 1e-5 there; every other function agrees to rtol 1e-5, atol 1e-6.
    atol = 1e-5 if name == "refract" else 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=atol)
