"""csrc/brute.cu's division-free gate on the CPU: a numpy float32 model of
the test's front (mt_front: p, det, the t-vector, a = t.p, q, b = d.q)
and of the gate (warp_may_hit) and the tail (mt_tail), each operation
rounded on its own as -fmad=false rounds it, IEEE division, subnormals
kept.  Over 10^6 random and adversarial ray-triangle pairs the gate never
rejects a pair that the whole test accepts, and the gate without either
of its margins does; the model's tail is the port's _mt_block bit for bit;
the constants of the model are brute.cu's; and the share of pairs the gate
rejects on the headline scene's camera rays.  The kernels' split of the
work (threads a ray, rays a thread, votes, the any hit's listing) is
modelled in tests/test_torch_brute.py."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_nee_camera_design import body, code  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops import intersect as isect  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays, generate_camera_rays  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402
from tpu_pathtracer_torch.utils import rng  # noqa: E402

F = np.float32
SOURCE = Path(__file__).resolve().parent.parent / "tpu_pathtracer_torch" / "csrc" / "brute.cu"
DET_EPS = F(1e-12)
M_SCALE = F(2.0 ** -80)  # the gate's m = |det| 2^-80
K = F(1 + 2.0 ** -20)    # the gate's k: reject where a + b > |det| k
SIGN = np.uint32(0x80000000)


def front(v0, e1, e2, o, d):
    """mt_front on float32 arrays of 3-vectors (the last axis; the others
    broadcast): det, a, b and q, in its order."""
    with np.errstate(all="ignore"):
        px = d[..., 1] * e2[..., 2] - d[..., 2] * e2[..., 1]
        py = d[..., 2] * e2[..., 0] - d[..., 0] * e2[..., 2]
        pz = d[..., 0] * e2[..., 1] - d[..., 1] * e2[..., 0]
        det = e1[..., 0] * px + e1[..., 1] * py + e1[..., 2] * pz
        tx, ty, tz = o[..., 0] - v0[..., 0], o[..., 1] - v0[..., 1], o[..., 2] - v0[..., 2]
        a = tx * px + ty * py + tz * pz
        qx = ty * e1[..., 2] - tz * e1[..., 1]
        qy = tz * e1[..., 0] - tx * e1[..., 2]
        qz = tx * e1[..., 1] - ty * e1[..., 0]
        b = d[..., 0] * qx + d[..., 1] * qy + d[..., 2] * qz
    return det, a, b, (qx, qy, qz)


def tail(det, a, b, q, e2, t_min, t_max):
    """mt_tail: (t, u, v, ok)."""
    with np.errstate(all="ignore"):
        inv = np.where(np.abs(det) > DET_EPS, F(1) / det, F(0)).astype(F)
        u, v = a * inv, b * inv
        t = (e2[..., 0] * q[0] + e2[..., 1] * q[1] + e2[..., 2] * q[2]) * inv
        ok = (np.abs(det) > DET_EPS) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min) & (t < t_max)
    return t, u, v, ok


def gate(det, a, b, m_scale=M_SCALE, k=K):
    """The gate of warp_may_hit for each pair (before the warp's vote):
    False only where the tail certainly fails."""
    with np.errstate(all="ignore"):
        d = np.abs(det)
        s = det.view(np.uint32) & SIGN
        sa, sb = (a.view(np.uint32) ^ s).view(F), (b.view(np.uint32) ^ s).view(F)
        m = d * m_scale
        return (d > DET_EPS) & ~(sa < -m) & ~(sb < -m) & ~(sa + sb > d * k)


def rows(v):
    """v0, e1, e2 of [...,3,3] float32 vertices, as _mt_block computes them."""
    with np.errstate(all="ignore"):
        return v[..., 0, :], v[..., 1, :] - v[..., 0, :], v[..., 2, :] - v[..., 0, :]


def gate_table(vertices, o, d):
    """The gate of every ray ([N,3] float32 origins and directions) and
    triangle ([T,3,3]): [N, T] bool."""
    v0, e1, e2 = (x[None] for x in rows(vertices))
    det, a, b, _ = front(v0, e1, e2, o[:, None], d[:, None])
    return gate(det, a, b)


def ulp_nudge(x, rs, steps=4):
    """x moved by up to `steps` float32 ulps, each coordinate on its own."""
    out = x.astype(F)
    for _ in range(steps):
        move = rs.randint(-1, 2, out.shape)
        out = np.where(move > 0, np.nextafter(out, F(np.inf)), np.where(move < 0, np.nextafter(out, F(-np.inf)), out))
    return out.astype(F)


def unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(F)


def random_pairs(rs, n):
    """Triangles and rays at scales 10^-3 to 10^3, anywhere."""
    scale = 10.0 ** rs.uniform(-3, 3, (n, 1, 1))
    v = (rs.randn(n, 3, 3) * scale).astype(F)
    o = (rs.randn(n, 3) * scale[:, 0] * 3).astype(F)
    return v, o, unit(rs.randn(n, 3))


def edge_pairs(rs, n):
    """Rays from around a triangle aimed at its edges and vertices (the
    barycentric coordinates on u = 0, v = 0 or u + v = 1, in float32),
    the target nudged by a few ulps; half of them segments ending there
    (the direction the unnormalized offset, so t is about 1)."""
    scale = 10.0 ** rs.uniform(-2, 2, (n, 1, 1))
    v = (rs.randn(n, 3, 3) * scale).astype(F)
    v0, e1, e2 = rows(v)
    w = rs.rand(n).astype(F)
    side = rs.randint(0, 4, n)
    bu = np.select([side == 0, side == 1, side == 2], [np.zeros_like(w), w, w], default=np.zeros_like(w))
    bv = np.select([side == 0, side == 1, side == 2], [w, np.zeros_like(w), F(1) - w], default=np.zeros_like(w))
    target = ulp_nudge(v0 + bu[:, None] * e1 + bv[:, None] * e2, rs)
    o = (target + rs.randn(n, 3).astype(F) * scale[:, 0] * 2).astype(F)
    seg = (target - o).astype(F)
    d = np.where((rs.rand(n) < 0.5)[:, None], seg, unit(seg)).astype(F)
    return v, o, d


def det_edge_pairs(rs, n):
    """Tiny triangles whose |det| straddles 1e-12, hit near the middle."""
    size = np.sqrt(1e-12 * 10.0 ** rs.uniform(-0.3, 0.3, (n, 1)))
    d = unit(rs.randn(n, 3))
    a1 = unit(np.cross(d, rs.randn(n, 3)))
    a2 = unit(np.cross(d, a1))
    v0 = rs.randn(n, 3).astype(F)
    v = np.stack([v0, v0 + size * a1, v0 + size * a2], axis=1).astype(F)
    target = v0 + (size * (a1 + a2) / 3)
    o = (target - d * rs.uniform(0.5, 5, (n, 1))).astype(F)
    return v, o, d


def underflow_pairs(rs, n):
    """Large triangles at the origin (|det| ~ 10^2 to 10^8) and origins a
    few subnormals away from v0, so that a = t.p and b = d.q are a few
    subnormals and u = a/det, v = b/det underflow to +-0: the case the
    margin m keeps out of the rejected set."""
    scale = 10.0 ** rs.uniform(1, 4, (n, 1, 1))
    v = (rs.randn(n, 3, 3) * scale).astype(F)
    v[:, 0] = 0.0
    tiny = np.float32(2.0 ** -149)
    o = (rs.randint(-8, 9, (n, 3)) * tiny).astype(F)
    return v, o, unit(rs.randn(n, 3))


def hypotenuse_pairs(rs, n):
    """Rays through points just across the edge u + v = 1 (a + b just
    above det), at random orientations and scales: the case the margin k
    keeps out of the rejected set."""
    scale = 10.0 ** rs.uniform(-1, 1, (n, 1, 1))
    v = (rs.randn(n, 3, 3) * scale).astype(F)
    v0, e1, e2 = rows(v)
    w = rs.rand(n).astype(F)
    target = ulp_nudge(v0 + w[:, None] * e1 + (F(1) - w)[:, None] * e2, rs, steps=2)
    d = unit(rs.randn(n, 3))
    o = (target - d * rs.uniform(0.1, 10, (n, 1)) * scale[:, 0]).astype(F)
    return v, o, d


def special_pairs(rs, n):
    """Random pairs with NaN, inf and -inf in random coordinates."""
    v, o, d = random_pairs(rs, n)
    for x in (v.reshape(n, 9), o, d):
        hit = rs.rand(*x.shape) < 0.05
        x[hit] = rs.choice(np.array([np.nan, np.inf, -np.inf], F), int(hit.sum()))
    return v, o, d


FAMILIES = {"random": random_pairs, "edges": edge_pairs, "det": det_edge_pairs, "underflow": underflow_pairs,
            "hypotenuse": hypotenuse_pairs, "special": special_pairs}
# pairs a family (10^6 in all)
SIZES = {"random": 300_000, "edges": 250_000, "det": 100_000, "underflow": 150_000, "hypotenuse": 150_000,
         "special": 50_000}
# (t_min, t_max) of the full test: the renderer's, a wide-open one that lets
# every barycentric margin show, and a segment ending at the triangle
SEGMENTS = ((1e-3, 1e16), (-np.inf, np.inf), (1e-3, 1.0))


def outcome(v, o, d, t_min, t_max, **gate_kw):
    v0, e1, e2 = rows(v)
    det, a, b, q = front(v0, e1, e2, o, d)
    _, _, _, ok = tail(det, a, b, q, e2, F(t_min), F(t_max))
    return gate(det, a, b, **gate_kw), ok


def test_model_constants_are_brute_cu():
    """The model's 1e-12, 2^-80 and 1 + 2^-20 are brute.cu's (and the
    gate's compares the model's), and the gate votes before the tail."""
    text = SOURCE.read_text()
    k = re.search(r"constexpr float kSumMargin = ([0-9.]+)f;", text).group(1)
    assert F(k) == K and float(k) == 1 + 2.0 ** -20
    body = text[text.index("bool warp_may_hit("):]
    body = body[:body.index("\n}\n")]
    assert "d * 0x1p-80f" in body and "d > 1e-12f" in body
    assert "__any_sync(0xffffffffu, (d > 1e-12f) & !(a < -m) & !(b < -m) & !(a + b > d * kSumMargin))" in body
    assert text.count("if (warp_may_hit(f)) {") == 2


@pytest.mark.parametrize("family", list(FAMILIES))
def test_front_and_tail_are_mt_block(family):
    """The model's front and tail give _mt_block's t, u, v and validity
    bit for bit on each family's pairs (20,000 of each; a NaN as a NaN,
    whatever its sign and payload)."""
    v, o, d = FAMILIES[family](np.random.RandomState(1), 20_000)
    v0, e1, e2 = rows(v)
    det, a, b, q = front(v0, e1, e2, o, d)
    t, u, w, ok = tail(det, a, b, q, e2, F(1e-3), F(1e16))
    tt, tu, tv, tok = _mt_pairs(v, o, d, 1e-3, 1e16)
    for mine, port in ((t, tt), (u, tu), (w, tv)):
        np.testing.assert_array_equal(np.isnan(mine), np.isnan(port))
        keep = ~np.isnan(mine)
        np.testing.assert_array_equal(mine[keep].view(np.int32), port[keep].view(np.int32))
    np.testing.assert_array_equal(ok, tok)


def _mt_pairs(v, o, d, t_min, t_max, chunk=256):
    """isect._mt_block of each ray with its own triangle (the diagonal of
    its [N, B] outputs), as numpy."""
    outs = [[], [], [], []]
    for s in range(0, v.shape[0], chunk):
        vt, ot, dt = (torch.as_tensor(x[s:s + chunk]) for x in (v, o, d))
        res = isect._mt_block(ot, dt, vt, t_min, t_max)
        for out, x in zip(outs, res):
            out.append(torch.diagonal(x).numpy())
    return [np.concatenate(x) for x in outs]


@pytest.mark.parametrize("t_min,t_max", SEGMENTS, ids=["renderer", "open", "segment"])
def test_gate_never_rejects_an_accepted_pair(t_min, t_max):
    """Over 10^6 pairs (random; rays at edges and vertices; |det| around
    1e-12; a and b a few subnormals, u and v underflowing; a + b just above
    det; NaN and inf), under each of SEGMENTS, no pair is rejected by the
    gate and accepted by the whole test.  Most of the random pairs are
    rejected, and on the open segment every family but NaN and inf has
    pairs that the test accepts (the underflow family's t is about 0)."""
    rs = np.random.RandomState(2)
    total = 0
    for family, make in FAMILIES.items():
        v, o, d = make(rs, SIZES[family])
        passed, ok = outcome(v, o, d, t_min, t_max)
        bad = ok & ~passed
        assert not bad.any(), (family, np.flatnonzero(bad)[:5])
        if family == "random":
            assert (~passed).mean() > 0.5
        if family != "special" and t_min == -np.inf:
            assert ok.any(), family
        total += v.shape[0]
    assert total >= 1_000_000


@pytest.mark.parametrize("margin", ["m", "k"])
def test_gate_without_its_margins_fails(margin):
    """The adversarial families are sharp: without m (a < 0 rejected where
    u underflows to -0.0) or with k = 1 (a + b > det rejected where u + v
    rounds to 1), the gate rejects pairs that the whole test accepts."""
    rs = np.random.RandomState(3)
    family = {"m": "underflow", "k": "hypotenuse"}[margin]
    kw = {"m": dict(m_scale=F(0)), "k": dict(k=F(1))}[margin]
    v, o, d = FAMILIES[family](rs, SIZES[family])
    passed, ok = outcome(v, o, d, -np.inf, np.inf, **kw)
    assert (ok & ~passed).sum() > 10
    passed, ok = outcome(v, o, d, -np.inf, np.inf)
    assert not (ok & ~passed).any()


def camera_rays(n, seed):
    """n of the headline camera's rays (1080p, no DOF) through random
    pixels, as float32 numpy origins and directions."""
    cfg = RenderConfig(dof=False)
    pix = torch.as_tensor(np.random.RandomState(seed).randint(0, cfg.width * cfg.height, n), dtype=torch.int32)
    seeds = rng.make_seeds(pix, torch.zeros_like(pix), 0)
    o, d, _ = generate_camera_rays(camera_arrays(Camera(), cfg, "cpu"), pix % cfg.width, pix // cfg.width, seeds, cfg)
    return o.numpy(), d.numpy()


def test_gate_share_on_the_headline_camera_rays(capsys):
    """The share of pairs the gate rejects on the headline scene (3,074
    triangles) against 1,024 of a 1080p frame's camera rays, and of the
    closest hit's votes at the headline's layout (8 threads a ray, 2 rays
    a thread: a vote covers 4 rays and 8 triangles) that take the tail:
    above 99% and below 10%; no pair rejected that the test accepts."""
    tri = procedural.three_spheres_scene(device="cpu").vertices.numpy()
    o, d = camera_rays(1024, 4)
    t_count = tri.shape[0]
    passes = np.zeros((1024, t_count), bool)
    oks = np.zeros((1024, t_count), bool)
    for i in range(0, 1024, 64):
        vv = np.broadcast_to(tri[None], (64, t_count, 3, 3)).reshape(-1, 3, 3)
        oo = np.repeat(o[i:i + 64], t_count, axis=0)
        dd = np.repeat(d[i:i + 64], t_count, axis=0)
        passed, ok = outcome(vv, oo, dd, 1e-3, 1e16)
        passes[i:i + 64], oks[i:i + 64] = passed.reshape(64, t_count), ok.reshape(64, t_count)
    assert not (oks & ~passes).any()
    rejected = 1 - passes.mean()
    # rays 8w + 2g + r (group g of 4, ray r of 2) and triangles 8c + s: a
    # vote of warp w, ray r, step c over g and s
    pad = (-t_count) % 8
    votes = np.pad(passes, ((0, 0), (0, pad))).reshape(1024 // 8, 4, 2, -1, 8).any(axis=(1, 4))
    with capsys.disabled():
        print(f"\n[gate] headline camera rays: the gate rejects {rejected:.4%} of {passes.size} pairs "
              f"({oks.mean():.4%} accepted by the whole test); {votes.mean():.4%} of the closest hit's votes "
              f"take the tail")
    assert rejected > 0.99 and votes.mean() < 0.1



def test_any_hit_lists_without_atomics_and_launches_are_ordinary():
    """The any hit lists its rays by ballots in shared memory, with no
    atomic and nothing of the host, and both kernels are ordinary launches
    (<<<>>>, no attribute, no wait).  That the any hit lets the NEE kernel
    start at its entry: tests/test_torch_nee_camera_design.py."""
    text = code("brute.cu")
    assert "wait_for_launch_before" not in text and "launch_order::launch(" not in text
    assert "ProgrammaticStreamSerialization" not in text
    assert "plan.kernel<<<" in body("brute.cu", "brute_launch")
    listing = body("brute.cu", "list_rays") + body("brute.cu", "any_hit")
    assert "__ballot_sync" in listing and "atomic" not in listing
    assert "cudaMemcpy" not in text and "cudaStreamSynchronize" not in text
