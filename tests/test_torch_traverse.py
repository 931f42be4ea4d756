"""Port parity: shadow-ray traversal (voidin_tpu_torch.rt.traverse, the
plain PyTorch twin of csrc/shadow_trace.cu) against the JAX package's
three traversals, occluded (per-ray stack loop), occluded_packets and
occluded_threaded, which give the same hits.

Scenes and rays as tests/test_traverse_threaded.py builds them (coherent
and incoherent rays, inactive lanes; one instance; no active ray) and
the adversarial sets of chip_smoke.shadow_edge_case (rays in box faces,
through shared edges and vertices, t_max landing on a triangle,
direction components 0 and +-1e-21, a pool without BVH whose leaves hold
MAX_LEAF triangles, no rays). Each package builds the scene on its own
World with the same BVH builder. Hits are compared bit for bit, only
where JAX reports 0 exhausted and 0 overflow (asserted). The packet stack
loop runs on the knot scene only: JAX's own tests hold it equal to the
other two (tests/test_traverse.py, test_traverse_threaded.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.rt import traverse as j_trav

import voidin_tpu_torch as pt
from voidin_tpu_torch.core import mathx
from voidin_tpu_torch.ops import shadow_trace as t_st
from voidin_tpu_torch.rt import traverse as t_trav

from chip_smoke import SHADOW_EDGE_CASES, _mesh_module, shadow_edge_case

torch.set_num_threads(2)


def _knot_world(pkg, seed=5, n_inst=5):
    """tests/test_traverse_threaded.py _scene_and_rays's scene on `pkg`'s
    World."""
    mesh = _mesh_module(pkg)
    w = pkg.World()
    knot = w.meshes.add(mesh.make_torus_knot(segments=48, sides=8))
    rng = np.random.default_rng(seed)
    for i in range(n_inst):
        t = mathx.from_translation(
            [2.0 * i - 4.0, float(rng.uniform(-1, 1)), -6.0]
        ) @ mathx.from_rotation_y(np.float32(rng.uniform(0, 6)))
        w.instances.add(np.asarray(t), knot, 0)
    return w, rng


def _knot_rays(rng, R=1000):
    og = np.stack(np.meshgrid(np.linspace(-5, 5, 25), np.linspace(-2, 2, 20),
                              indexing="ij"), -1).reshape(-1, 2)
    coherent_o = np.concatenate([og, np.full((500, 1), 2.0)],
                                axis=1).astype(np.float32)
    coherent_d = (np.array([0.0, 3.0, -9.0]) - coherent_o).astype(np.float32)
    rand_o = rng.uniform(-5, 5, (R - 500, 3)).astype(np.float32)
    rand_d = rng.uniform(-6, 6, (R - 500, 3)).astype(np.float32)
    active = rng.random(R) < 0.9
    return (np.concatenate([coherent_o, rand_o]),
            np.concatenate([coherent_d, rand_d]), active)


def _jax_hits(js, o, d, active, packets=False):
    """Hits of JAX's per-ray stack loop and stackless packet walk (and with
    `packets` its packet stack loop), each asserted exhausted- and
    overflow-free and equal to the others."""
    tlas, blas, inst, tri_pos = j_trav.scene_rays(js)
    o, d, act = jnp.asarray(o), jnp.asarray(d), jnp.asarray(active)
    runs = [j_trav.occluded(tlas, blas, inst, tri_pos, o, d, t_max=1.0,
                            active=act, max_steps=4096)]
    if packets:
        runs.append(j_trav.occluded_packets(
            tlas, blas, inst, tri_pos, o, d, t_max=1.0, active=act,
            max_steps=8 * 4096, packet=128))
    table, n_tlas, inst2, tri2 = j_trav.scene_rays_threaded(js)
    runs.append(j_trav.occluded_threaded(
        table, n_tlas, inst2, tri2, o, d, t_max=1.0, active=act,
        max_steps=8 * 4096, max_leaf=js.meshes.bvh_max_leaf))
    hits = [np.asarray(r.hit) for r in runs]
    for r, h in zip(runs, hits):
        assert int(r.exhausted) == 0 and int(r.overflow) == 0
        np.testing.assert_array_equal(h, hits[0])
    return hits[0]


def _port_walk(ps, o, d, active, **kw):
    tables = t_trav.scene_rays_threaded(ps)
    return t_trav.occluded_reference(
        *tables, torch.from_numpy(o), torch.from_numpy(d),
        active=None if active is None else torch.from_numpy(active),
        max_leaf=ps.meshes.bvh_max_leaf, **kw)


@pytest.fixture(scope="module")
def knot_scenes():
    jw, jrng = _knot_world(vt)
    pw, prng = _knot_world(pt)
    o, d, active = _knot_rays(jrng)
    return jw.device(with_tlas=True), pw.device("cpu", with_tlas=True), \
        (o, d, active)


def test_threaded_tables_match_jax(knot_scenes):
    js, ps, _ = knot_scenes
    jt = j_trav.scene_rays_threaded(js)
    tt = t_trav.scene_rays_threaded(ps)
    assert jt[1] == tt[1]
    for a, b in zip((jt[0], jt[2], jt[3]), (tt[0], tt[2], tt[3])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_walk_matches_jax_traversals(knot_scenes):
    js, ps, (o, d, active) = knot_scenes
    want = _jax_hits(js, o, d, active, packets=True)
    res, counts = _port_walk(ps, o, d, active)
    assert int(res.exhausted) == 0 and int(res.overflow) == 0
    np.testing.assert_array_equal(res.hit.numpy(), want)
    assert want.any() and not res.hit.numpy()[~active].any()
    assert counts.node_visits > counts.instance_entries > 0
    assert counts.triangle_tests > 0


def test_single_instance_and_inactive():
    """test_traverse_threaded.py:100-131 on the port: one instance (the
    TLAS root is a leaf); all rays inactive walk nothing."""
    jw, pw = vt.World(), pt.World()
    for w, pkg in ((jw, vt), (pw, pt)):
        knot = w.meshes.add(_mesh_module(pkg).make_torus_knot(segments=24,
                                                              sides=6))
        w.instances.add(np.eye(4, dtype=np.float32), knot, 0)
    js, ps = jw.device(with_tlas=True), pw.device("cpu", with_tlas=True)
    rng = np.random.default_rng(0)
    o = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    d = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    every = np.ones(64, bool)
    res, _ = _port_walk(ps, o, d, None)
    np.testing.assert_array_equal(res.hit.numpy(), _jax_hits(js, o, d, every))
    none, counts = _port_walk(ps, o, d, np.zeros(64, bool))
    assert not none.hit.any() and counts.node_visits == 0


@pytest.mark.parametrize("kind", SHADOW_EDGE_CASES)
def test_edge_sets_match_jax(kind):
    jw, o, d, active = shadow_edge_case(vt, kind)
    pw, o2, d2, active2 = shadow_edge_case(pt, kind)
    np.testing.assert_array_equal(o, o2)
    np.testing.assert_array_equal(active, active2)
    ps = pw.device("cpu", with_tlas=True)
    res, _ = _port_walk(ps, o, d, active)
    assert int(res.exhausted) == 0
    if not len(o):
        assert res.hit.shape == (0,)
        return
    want = _jax_hits(jw.device(with_tlas=True), o, d, active)
    np.testing.assert_array_equal(res.hit.numpy(), want)
    assert want.any() and not want.all()


def test_leaves_above_max_leaf_are_refused():
    """A pool built without BVH gives the builtin res-10 sphere one leaf
    of 6,320 triangles: the packing refuses it, as JAX's does."""
    w = pt.World(build_bvh=False)
    w.instances.add(np.eye(4, dtype=np.float32), 3, 0)
    ps = w.device("cpu", with_tlas=True)
    assert ps.meshes.bvh_max_leaf > t_trav.MAX_LEAF
    with pytest.raises(ValueError, match="MAX_LEAF"):
        t_trav.scene_rays_threaded(ps)


def test_step_limit_counts_exhausted_rays(knot_scenes):
    """A step limit cuts walks short: the cut rays count as exhausted, hit
    nothing they would not hit unlimited, and the count falls to 0 as the
    limit grows."""
    _, ps, (o, d, active) = knot_scenes
    full, _ = _port_walk(ps, o, d, active)
    prev = None
    for steps in (1, 4, 16, 64, t_trav.MAX_STEPS):
        res, counts = _port_walk(ps, o, d, active, max_steps=steps)
        assert not (res.hit & ~full.hit).any()
        ex = int(res.exhausted)
        assert prev is None or ex <= prev
        prev = ex
    assert int(_port_walk(ps, o, d, active, max_steps=1)[0].exhausted) > 0
    assert prev == 0


def test_occluded_on_the_cpu_runs_the_twin(knot_scenes):
    """ops.shadow_trace.occluded on CPU tensors: the twin, no launch."""
    _, ps, (o, d, active) = knot_scenes
    before = t_st.LAUNCHES
    tables = t_trav.scene_rays_threaded(ps)
    got = t_st.occluded(*tables, torch.from_numpy(o), torch.from_numpy(d),
                        active=torch.from_numpy(active),
                        max_leaf=ps.meshes.bvh_max_leaf)
    want, _ = _port_walk(ps, o, d, active)
    assert t_st.LAUNCHES == before
    np.testing.assert_array_equal(got.hit.numpy(), want.hit.numpy())


def test_shadow_rows_unpack_to_the_threaded_table(knot_scenes):
    """pack_shadow_rows, the shadow kernel's layout: its rows unpack to
    pack_threaded_table's (boxes, children, TLAS leaves' instances, BLAS
    left_first and counts; a TLAS node's second child is its first child's
    exit link), the instance rows keep the inverse transform and the
    BLAS root and first triangle, and the triangle edges are v1 - v0 and
    v2 - v0 bit for bit."""
    _, ps, _ = knot_scenes
    table, n_tlas, inst, tri_pos = t_trav.scene_rays_threaded(ps)
    rows = t_trav.pack_shadow_rows(table, n_tlas, inst, tri_pos)
    tl = rows.top[:(n_tlas + 1) * 8].view(n_tlas + 1, 8)
    tl_i = tl.view(torch.int32)
    t = table[:n_tlas]
    assert torch.equal(tl[:n_tlas, 0:3], t[:, 0:3])
    assert torch.equal(tl[:n_tlas, 4:7], t[:, 4:7])
    assert torch.equal(tl_i[:n_tlas, 3].float(), t[:, 3])
    internal = t[:, 3] >= 0
    left = t[internal, 3].long()
    assert torch.equal(tl_i[:n_tlas, 7][internal].float(), t[left, 7] - 1.0)
    assert (tl_i[:n_tlas, 7][~internal] == -1).all()
    assert tl_i[n_tlas, 3] == 0 and tl_i[n_tlas, 7] == t_trav.NO_CHILD
    ir = rows.top[(n_tlas + 1) * 8:].view(rows.n_inst, 16)
    assert torch.equal(ir[:, :12], inst[:, :12])
    assert torch.equal(ir[:, 12:14].view(torch.int32).float(), inst[:, 16:18])
    b = table[n_tlas:]
    blas_i = rows.blas.view(torch.int32)
    assert torch.equal(rows.blas[:, 0:3], b[:, 0:3])
    assert torch.equal(rows.blas[:, 4:7], b[:, 4:7])
    assert torch.equal(blas_i[:, 3].float(), b[:, 3])
    assert torch.equal(blas_i[:, 7].float(), b[:, 8])
    v0, v1, v2 = tri_pos[:, 0:3], tri_pos[:, 3:6], tri_pos[:, 6:9]
    assert torch.equal(rows.tris[:, 0:3], v0)
    assert torch.equal(rows.tris[:, 3:6].view(torch.int32),
                       (v1 - v0).view(torch.int32))
    assert torch.equal(rows.tris[:, 6:9].view(torch.int32),
                       (v2 - v0).view(torch.int32))
    assert (rows.tris[:, 9:] == 0).all()
