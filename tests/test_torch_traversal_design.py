"""The two arguments that the two-level CUDA kernels' design rests on
(tpu_pathtracer_torch/csrc/cluster_streamed.cuh), checked on the CPU
against the plain version's own pieces with numpy-seeded inputs:

(a) a ray's T threads each scan every T-th triangle of a cluster and the T
    partial winners merge by smaller t, then lower triangle id: that is the
    sequential scan's winner (prim and uv included), ties and K < T
    included; for any hit the OR of the T flags is the scan's flag;
(b) a vote over many boxes at once, taken with the limits of that moment,
    gives a mask that contains every box the exact votes then pass, so a
    walk restricted to the masks visits what the plain version visits: in
    the streamed route's ascending order (kernels 3 and 6) and in the hier
    route's per-packet front-to-back order (kernels 2 and 5);
(c) the flat route's walk (kernels 1 and 4, kFlat): a batch of 31 visit
    positions voted on at once, the lowest passing position tested, its
    next one prefetched, the rest voted on again, a ray's word of the vote
    taken again only after its own limit moved, and the any-hit packet
    leaving once every ray is occluded, gives the flat plain versions'
    results and counts.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pathtracer_torch.accel.build import build_accel  # noqa: E402
from tpu_pathtracer_torch.ops import intersect_cluster as ic  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402

T_MIN, T_MAX = 0.01, 1e16
SUPER_BATCH = 31  # kSuperBatch of cluster_streamed.cuh


@pytest.fixture(scope="module")
def accel():
    """Three spheres (8, 16): 770 triangles in 97 clusters of 8."""
    acc = build_accel(procedural.three_spheres_scene(8, 16, device="cpu"), cluster_size=8).accel
    assert acc.num_clusters == 97
    return acc


def rays(seed, n, parked=0):
    """Rays from around the scene toward random points on it, a quarter in
    random directions; the last `parked` rays parked at (3e37, 0, 0)."""
    rs = np.random.RandomState(seed)
    o = (rs.randn(n, 3) * [5.0, 2.0, 5.0] + [0.0, 2.5, 0.0]).astype(np.float32)
    target = (rs.rand(n, 3) * [8.0, 2.0, 2.0] - [4.0, 0.0, 1.0]).astype(np.float32)
    d = target - o
    d[: n // 4] = rs.randn(n // 4, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    if parked:
        o[-parked:] = [3.0e37, 0.0, 0.0]
        d[-parked:] = [1.0, 0.0, 0.0]
    return torch.as_tensor(o), torch.as_tensor(d)


def rows_with_ties(acc, tri_test, k):
    """The scene's rows cut to K = k triangles a cluster, with triangles
    repeated inside each cluster so that a ray meets exact ties in t."""
    tris = (acc.tris16bw if tri_test == "bw" else acc.tris16)[:, :k].clone()
    if k >= 8:
        tris[:, 5] = tris[:, 2]
        tris[:, 7] = tris[:, 2]
        tris[:, 4] = tris[:, 1]
    elif k >= 3:
        tris[:, 2] = tris[:, 0]
    return tris.contiguous()


def split_winner(tc, u, v, threads):
    """The kernel's scan of one cluster, in numpy: thread `sub` of a ray
    scans triangles sub, sub + T, ... keeping a strictly smaller t, then
    the T partial winners merge pairwise (a butterfly over the thread
    index) by smaller t, then lower k.  tc, u, v: [M,K,R].  Returns the
    merged (t, k, u, v), each [M,R], as thread 0 holds them."""
    m, k_count, r = tc.shape
    parts = []
    for sub in range(threads):
        t_blk = np.full((m, r), np.inf, np.float32)
        k_blk = np.zeros((m, r), np.int64)
        u_blk = np.zeros((m, r), np.float32)
        v_blk = np.zeros((m, r), np.float32)
        for k in range(sub, k_count, threads):
            take = tc[:, k] < t_blk
            t_blk = np.where(take, tc[:, k], t_blk)
            k_blk = np.where(take, k, k_blk)
            u_blk = np.where(take, u[:, k], u_blk)
            v_blk = np.where(take, v[:, k], v_blk)
        parts.append((t_blk, k_blk, u_blk, v_blk))
    off = 1
    while off < threads:
        merged = []
        for sub in range(threads):
            (t1, k1, u1, v1), (t2, k2, u2, v2) = parts[sub], parts[sub ^ off]
            take = (t2 < t1) | ((t2 == t1) & (k2 < k1))
            merged.append(tuple(np.where(take, b, a) for a, b in ((t1, t2), (k1, k2), (u1, u2), (v1, v2))))
        parts = merged
        off *= 2
    for other in parts[1:]:  # every thread of the ray ends with the same winner
        for a, b in zip(parts[0], other):
            np.testing.assert_array_equal(a, b)
    return parts[0]


@pytest.mark.parametrize("k", [8, 3, 1], ids=["K8", "K3", "K1"])
@pytest.mark.parametrize("tri_test", ["bw", "mt"])
@pytest.mark.parametrize("threads", [2, 4, 8])
def test_split_scan_merge_is_the_sequential_winner(accel, threads, tri_test, k):
    """(a), closest hit: over a run of clusters, the merged partial winners
    replace a ray's best exactly as _Packets.visit does: t, prim, u and v
    bit for bit, with exact ties in t inside a cluster and K < T."""
    tris = rows_with_ties(accel, tri_test, k)
    o, d = rays(3, 256)
    pk = ic._Packets(tris, o, d, T_MIN, T_MAX, 32, tri_test)
    p = pk.all.shape[0]
    best_t = np.full((p, 32), T_MAX, np.float32)
    best_p = np.full((p, 32), ic.MISS_PRIM, np.int64)
    best_u = np.zeros((p, 32), np.float32)
    best_v = np.zeros((p, 32), np.float32)
    ties = 0
    for c in range(0, 97, 3):
        cc = torch.full((p,), c, dtype=torch.int32)
        tc, u, v = (x.numpy() for x in pk.tests(pk.all, cc))
        finite = np.where(np.isfinite(tc), tc, np.nan)
        ties += int((np.sum(finite == np.nanmin(np.where(np.isfinite(tc), tc, np.inf), axis=1, keepdims=True), axis=1) > 1).sum())
        t_blk, k_blk, u_blk, v_blk = split_winner(tc, u, v, threads)
        improved = t_blk < best_t
        best_t = np.where(improved, t_blk, best_t)
        best_p = np.where(improved, c * k + k_blk, best_p)
        best_u = np.where(improved, u_blk, best_u)
        best_v = np.where(improved, v_blk, best_v)
        pk.visit(pk.all, cc, cc)
    np.testing.assert_array_equal(best_t, pk.best_t.numpy())
    np.testing.assert_array_equal(best_p, pk.best_p.numpy())
    np.testing.assert_array_equal(best_u, pk.best_u.numpy())
    np.testing.assert_array_equal(best_v, pk.best_v.numpy())
    assert (best_p != ic.MISS_PRIM).sum() > 20
    if k >= 3:
        assert ties > 0  # some ray's closest hit in a cluster was an exact tie


@pytest.mark.parametrize("k", [8, 1], ids=["K8", "K1"])
@pytest.mark.parametrize("threads", [2, 4, 8])
def test_split_flags_or_is_the_sequential_flag(accel, threads, k):
    """(a), any hit: a ray is occluded by a cluster when one of its T
    threads meets one of its triangles, as _Occlusion.visit sets it."""
    tris = rows_with_ties(accel, "bw", k)
    o, d = rays(4, 256)
    pk = ic._Occlusion(tris, o, d, T_MIN, T_MAX, 32, "bw")
    occ = np.zeros((pk.all.shape[0], 32), bool)
    for c in range(0, 97, 3):
        cc = torch.full_like(pk.all, c)
        ok = np.isfinite(pk.tests(pk.all, cc)[0].numpy())
        hit = np.zeros_like(occ)
        for sub in range(threads):
            hit |= ok[:, sub::threads].any(axis=1) if sub < k else False
        occ |= hit
        pk.visit(pk.all, cc)
    np.testing.assert_array_equal(occ, pk.occ.numpy())
    assert 0 < occ.sum() < occ.size


def masked_walk(pk, aabb_child, aabb_super, branch, closest, order_super=None):
    """The kernels' walk in the plain version's pieces: the supers in
    batches of 31 visit positions, voted on at once at the batch's entry;
    each passing super's children voted on at once at the super's entry;
    the exact votes, at each box's turn, taken only inside those masks.
    Without `order_super` the streamed route's ascending order (position =
    super id, children at or past the cluster count never); with it the
    hier route's per-packet order (the super at a position is
    order_super[octant of the packet's first ray], every child voted on,
    rows clamped to the last cluster).  Returns (boxes the exact votes
    passed outside a mask, boxes inside a mask that their exact vote then
    rejected)."""
    num_clusters = pk.tris.shape[0]
    outside = rejected = 0

    def visit(on, c):
        row = torch.clamp(c, max=num_clusters - 1)
        if closest:
            pk.visit(on, c, row)
        else:
            pk.visit(on, row)

    for s0 in range(0, aabb_super.shape[0], SUPER_BATCH):
        batch = range(s0, min(s0 + SUPER_BATCH, aabb_super.shape[0]))
        ids = [order_super[pk.octant, pos] if order_super is not None else torch.full_like(pk.all, pos)
               for pos in batch]
        super_mask = [pk.overlaps(aabb_super[s], pk.all) for s in ids]
        for pos, s, mask in zip(batch, ids, super_mask):
            exact = pk.overlaps(aabb_super[s], pk.all)
            outside += int((exact & ~mask).sum())
            rejected += int((mask & ~exact).sum())
            live, s = pk.all[exact & mask], s[exact & mask]
            count = branch if order_super is not None else min(branch, num_clusters - pos * branch)
            child_mask = [pk.overlaps(aabb_child[s * branch + j], live) for j in range(count)]
            for j in range(count):
                c = s * branch + j
                exact_c = pk.overlaps(aabb_child[c], live)
                outside += int((exact_c & ~child_mask[j]).sum())
                rejected += int((child_mask[j] & ~exact_c).sum())
                on = exact_c & child_mask[j]
                visit(live[on], c[on])
    return outside, rejected


@pytest.mark.parametrize("rays_per_tile", [32, 512])
@pytest.mark.parametrize("tri_test", ["bw", "mt"])
@pytest.mark.parametrize("kind", ["closest", "any"])
def test_masks_at_entry_contain_every_box_visited(accel, kind, tri_test, rays_per_tile):
    """(b): for every packet, batch and passing super, the masks taken with
    the limits at entry contain every box whose exact vote passes, so the
    walk restricted to the masks gives the plain version's results and its
    counts of visits and tests; and the masks are not exact, so the
    restriction is real: limits tighten while a super is walked."""
    closest = kind == "closest"
    tris = accel.tris16bw if tri_test == "bw" else accel.tris16
    child, supers = ic.streamed_pads(accel.aabb8, branch=2)  # 49 supers: two batches
    o, d = rays(5, 3000, parked=500)
    plain = ic.intersect_clusters_streamed_plain if closest else ic.occluded_clusters_streamed_plain
    want_stats = {}
    want = plain(tris, child, supers, o, d, T_MIN, T_MAX, rays_per_tile, 2, tri_test, stats=want_stats)
    got_stats = {}
    pk = (ic._Packets if closest else ic._Occlusion)(tris, o, d, T_MIN, T_MAX, rays_per_tile, tri_test, got_stats)
    outside, rejected = masked_walk(pk, child, supers, 2, closest)
    assert outside == 0
    if rays_per_tile == 32:
        assert rejected > 0  # at 512 only six packets vote and the masks may be exact
    got = pk.result()
    for a, b in zip(got if closest else (got,), want if closest else (want,)):
        assert torch.equal(a, b)
    assert got_stats == want_stats and want_stats["visits"] > 0
    hits = (want[1] != ic.MISS_PRIM) if closest else want
    assert 500 < int(hits.sum()) < 2500 and not hits[-500:].any()


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_masks_at_entry_path_branch(accel, kind):
    """(b) at the render path's branch of 16 (7 supers, the last a boundary
    super whose box is huge and whose children past the cluster count are
    never tested) and packets of 64."""
    closest = kind == "closest"
    child, supers = ic.streamed_pads(accel.aabb8, branch=16)
    assert supers.shape[0] * 16 > accel.num_clusters
    o, d = rays(6, 2000, parked=100)
    plain = ic.intersect_clusters_streamed_plain if closest else ic.occluded_clusters_streamed_plain
    want_stats, got_stats = {}, {}
    want = plain(accel.tris16bw, child, supers, o, d, T_MIN, T_MAX, 64, 16, "bw", stats=want_stats)
    pk = (ic._Packets if closest else ic._Occlusion)(accel.tris16bw, o, d, T_MIN, T_MAX, 64, "bw", got_stats)
    outside, _ = masked_walk(pk, child, supers, 16, closest)
    assert outside == 0
    got = pk.result()
    for a, b in zip(got if closest else (got,), want if closest else (want,)):
        assert torch.equal(a, b)
    assert got_stats == want_stats and want_stats["visits"] > 0


def spread_rays(seed, n, parked):
    """`rays`, shuffled with rays in random directions so that the first
    rays of the packets fall in all eight octants."""
    o, d = rays(seed, n, parked)
    rs = np.random.RandomState(seed + 100)
    pick = rs.rand(n - parked) < 0.5
    d_rand = rs.randn(n - parked, 3).astype(np.float32)
    d_rand /= np.linalg.norm(d_rand, axis=1, keepdims=True)
    d[: n - parked][torch.as_tensor(pick)] = torch.as_tensor(d_rand[pick])
    return o, d


@pytest.mark.parametrize("rays_per_tile", [32, 512])
@pytest.mark.parametrize("tri_test", ["bw", "mt"])
@pytest.mark.parametrize("kind", ["closest", "any"])
def test_masks_at_entry_per_packet_order(accel, kind, tri_test, rays_per_tile):
    """(b) in the hier route's visit order: each packet walks the supers
    in its first ray's octant order (order_super, 13 supers of 8, the last
    with padding children whose rows clamp to the last cluster); the walk
    restricted to the masks gives intersect_clusters_hier_plain's or
    occluded_clusters_hier_plain's results and counts, and at packets of
    32 the masks are not exact."""
    closest = kind == "closest"
    tris = accel.tris16bw if tri_test == "bw" else accel.tris16
    o, d = spread_rays(7, 3000, parked=500)
    packets = ic._PacketRays(tris, o, d, T_MIN, T_MAX, rays_per_tile, tri_test, None)
    octants = set(packets.octant.tolist())
    assert len(octants) == 8 if rays_per_tile == 32 else len(octants) >= 3
    plain = ic.intersect_clusters_hier_plain if closest else ic.occluded_clusters_hier_plain
    boxes = (accel.aabb8_child, accel.aabb8_super, accel.order_super)
    assert accel.aabb8_super.shape[0] * accel.super_branch > accel.num_clusters  # padding children
    want_stats, got_stats = {}, {}
    want = plain(tris, *boxes, o, d, T_MIN, T_MAX, rays_per_tile, accel.super_branch, tri_test, stats=want_stats)
    pk = (ic._Packets if closest else ic._Occlusion)(tris, o, d, T_MIN, T_MAX, rays_per_tile, tri_test, got_stats)
    outside, rejected = masked_walk(pk, boxes[0], boxes[1], accel.super_branch, closest, order_super=boxes[2])
    assert outside == 0
    if rays_per_tile == 32:
        assert rejected > 0
    got = pk.result()
    for a, b in zip(got if closest else (got,), want if closest else (want,)):
        assert torch.equal(a, b)
    assert got_stats == want_stats and want_stats["visits"] > 0
    hits = (want[1] != ic.MISS_PRIM) if closest else want
    assert 300 < int(hits.sum()) < 2500 and not hits[-500:].any()


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_masks_at_entry_per_packet_batches(kind):
    """(b) in per-packet order over several batches of super votes: the
    scene's clusters in supers of 2 (49 supers, two batches), packets of
    32."""
    closest = kind == "closest"
    acc = build_accel(procedural.three_spheres_scene(8, 16, device="cpu"), cluster_size=8, super_branch=2).accel
    assert acc.super_branch == 2 and acc.aabb8_super.shape[0] > SUPER_BATCH
    o, d = spread_rays(8, 2000, parked=100)
    plain = ic.intersect_clusters_hier_plain if closest else ic.occluded_clusters_hier_plain
    boxes = (acc.aabb8_child, acc.aabb8_super, acc.order_super)
    want_stats, got_stats = {}, {}
    want = plain(acc.tris16bw, *boxes, o, d, T_MIN, T_MAX, 32, 2, "bw", stats=want_stats)
    pk = (ic._Packets if closest else ic._Occlusion)(acc.tris16bw, o, d, T_MIN, T_MAX, 32, "bw", got_stats)
    outside, rejected = masked_walk(pk, boxes[0], boxes[1], 2, closest, order_super=boxes[2])
    assert outside == 0 and rejected > 0
    got = pk.result()
    for a, b in zip(got if closest else (got,), want if closest else (want,)):
        assert torch.equal(a, b)
    assert got_stats == want_stats and want_stats["visits"] > 0


def flat_walk(pk, aabb8, order, closest):
    """The kFlat walk of streamed_kernel, one packet at a time, in the plain
    version's pieces: the clusters at visit positions order[octant of the
    packet's first ray] in batches of 31; each ray's word of the vote (the
    batch's clusters it overlaps within its limit) taken at the batch's
    entry and again, over its old word, only after its best t fell (any
    hit: never, and an occluded ray's word is not counted); the vote is the
    OR of the words over the candidates still left; its lowest position is
    tested at once and leaves the candidates, and the next one is the
    prefetch guess; an any-hit packet stops once every ray is occluded (the
    alive bit).  Returns (prefetch guesses, guesses the next vote
    confirmed, clusters tested past the first batch)."""
    num = order.shape[1]
    guesses = confirmed = late = 0
    for p in range(pk.all.shape[0]):
        idx = pk.all[p : p + 1]
        visit = order[pk.octant[p]]
        alive = True
        for s0 in range(0, num, SUPER_BATCH):
            if not alive:
                break
            ids = visit[s0 : min(s0 + SUPER_BATCH, num)]
            rep = idx.expand(ids.numel())

            def words(limit):  # [R, batch]: does ray r overlap cluster ids[b] within its limit?
                return pk.slab(aabb8[ids], rep, limit).T

            limit = pk.best_t[p][None] if closest else pk.t_max
            mine = words(limit)
            voted_t = pk.best_t[p].clone() if closest else None
            cand = torch.ones(ids.numel(), dtype=torch.bool)
            guess = None
            while True:
                if closest:
                    moved = pk.best_t[p] != voted_t
                    if moved.any():
                        mine[moved] = (words(pk.best_t[p][None]) & mine & cand)[moved]
                        voted_t = pk.best_t[p].clone()
                    cand = (mine & cand).any(dim=0)
                else:
                    live = ~pk.occ[p]
                    alive = bool(live.any())
                    cand = (mine & cand & live[:, None]).any(dim=0)
                if not alive or not cand.any():
                    break
                b = int(cand.nonzero()[0])
                cand[b] = False
                c = ids[b : b + 1]
                if guess is not None:
                    guesses += 1
                    confirmed += int(c) == guess
                rest = cand.nonzero()
                guess = int(ids[int(rest[0])]) if rest.numel() else None
                late += s0 > 0
                if closest:
                    pk.visit(idx, c, c)
                else:
                    pk.visit(idx, c)
    return guesses, confirmed, late


def check_flat_walk(tris, aabb8, order, o, d, rays_per_tile, tri_test, closest, parked):
    """flat_walk against the flat plain version: results bit for bit and the
    same visits and tests; returns (flat_walk's counts, the rays that hit
    or are occluded)."""
    plain = ic.intersect_clusters_plain if closest else ic.occluded_clusters_plain
    want_stats, got_stats = {}, {}
    want = plain(tris, aabb8, order, o, d, T_MIN, T_MAX, rays_per_tile, tri_test, stats=want_stats)
    pk = (ic._Packets if closest else ic._Occlusion)(tris, o, d, T_MIN, T_MAX, rays_per_tile, tri_test, got_stats)
    counts = flat_walk(pk, aabb8, order, closest)
    got = pk.result()
    for a, b in zip(got if closest else (got,), want if closest else (want,)):
        assert torch.equal(a, b)
    assert got_stats == want_stats and want_stats["visits"] > 0
    hits = (want[1] != ic.MISS_PRIM) if closest else want
    assert not hits[o.shape[0] - parked :].any()
    return counts, hits


@pytest.mark.parametrize("rays_per_tile", [32, 1024])
@pytest.mark.parametrize("tri_test", ["bw", "mt"])
@pytest.mark.parametrize("kind", ["closest", "any"])
def test_flat_walk_is_the_flat_plain_version(accel, kind, tri_test, rays_per_tile):
    """(c) on the 97 clusters of 8 (four batches of votes), triangles
    repeated inside each cluster so that rays meet exact ties in t, packets
    whose first rays fall in every octant, and parked rays: the kFlat walk
    gives intersect_clusters_plain's or occluded_clusters_plain's results
    and counts, and its prefetch guesses are mostly confirmed."""
    closest = kind == "closest"
    tris = rows_with_ties(accel, tri_test, 8)
    o, d = spread_rays(9, 3000, parked=200)
    assert accel.order.shape == (8, 97)
    (guesses, confirmed, late), hits = check_flat_walk(tris, accel.aabb8, accel.order, o, d, rays_per_tile,
                                                       tri_test, closest, 200)
    assert 300 < int(hits.sum()) < 2800
    assert 0 < confirmed <= guesses and late > 0


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_flat_walk_crosses_a_batch(kind):
    """(c) on BASELINE config 1's scene, single_sphere_scene(32, 64): 33
    clusters of 128, so a packet that passes the first batch's 31 visit
    positions goes on to a second batch of two; packets of 1,024."""
    acc = build_accel(procedural.single_sphere_scene(32, 64, device="cpu")).accel
    assert acc.num_clusters == 33
    rs = np.random.RandomState(10)
    o = (rs.randn(6000, 3) * 3.0).astype(np.float32)
    d = -o + rs.randn(6000, 3).astype(np.float32) * 0.3
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    o[-500:] = [3.0e37, 0.0, 0.0]
    d[-500:] = [1.0, 0.0, 0.0]
    o, d = torch.as_tensor(o), torch.as_tensor(d, dtype=torch.float32)
    (_, _, late), hits = check_flat_walk(acc.tris16bw, acc.aabb8, acc.order, o, d, 1024, "bw", kind == "closest",
                                         500)
    assert 1000 < int(hits.sum()) < 5500
    assert late > 0  # some packet tested a cluster of the second batch
