"""The one-launch dense resolve (ops/resolve.py resolve_dense) on the CPU,
where it runs the plain PyTorch twin its caller hands it
(passes/resolve.py resolve_dense_reference), and resolve_gbuffer's choice
of it.

The choice is a static test of the config's record and coherent options,
the scene's flags and the VisBuffer's runner-up: every option or flag
outside the kernel's envelope keeps the eager chain, the default takes
the kernel. On tests/test_torch_records.py's scenes (128x64, the port's
VisBuffer) resolve_dense gives the words of the dense _pixel_fields as
resolve_gbuffer computed them before the kernel (the pixel centres
written out here as it wrote them), on the whole image and on a row
window of the sharded frame; resolve_gbuffer's default frame is the
_assemble of those fields. The card holds the kernel to this twin word
for word (tests/test_torch_cuda.py -k resolve_dense).
"""

import dataclasses
import types

import pytest
import torch

from voidin_tpu_torch.ops import resolve as dense_op
from voidin_tpu_torch.passes import resolve as t_resolve
from voidin_tpu_torch.passes.gbuffer import VisBuffer
from voidin_tpu_torch.passes.shading import pixel_rows

from tests.test_torch_records import case_of, port_cfg, port_vis

torch.set_num_threads(2)

# (RasterConfig field or scene / VisBuffer flag, value, takes the kernel)
ROUTES = [
    (None, None, True),
    ("slot_resolve", True, False),
    ("quad_rate_resolve", True, False),
    ("slim_rec", True, False),
    ("fused_resolve_rec", True, False),
    ("fused_inst_rec", True, False),
    ("inst_rec_f16", True, False),
    ("scene.emissive_const", False, False),
    ("scene.mr_const", False, False),
    ("vis.tri_id2", "runner-up", False),
    # options that keep the default layout and words
    ("planar_resolve", True, True),
    ("sort_payload", True, True),
    ("two_stream_bin", False, True),
    ("debug_bounds", True, True),
    ("lazy_alpha_resolve", False, True),
    ("scene.no_normal_maps", False, True),
    ("scene.albedo_srgb", None, True),
]


@pytest.mark.parametrize("key,value,kernel", ROUTES,
                         ids=[str(r[0]) for r in ROUTES])
def test_path_choice_is_static(key, value, kernel):
    cfg = port_cfg()
    scene = types.SimpleNamespace(emissive_const=True, mr_const=True,
                                  no_normal_maps=True, albedo_srgb=True)
    vis = types.SimpleNamespace(tri_id2=None)
    if key is None:
        pass
    elif key.startswith("scene."):
        setattr(scene, key[6:], value)
    elif key.startswith("vis."):
        setattr(vis, key[4:], torch.zeros(2, 2, dtype=torch.int32))
    else:
        cfg = dataclasses.replace(cfg, **{key: value})
    assert t_resolve.takes_dense_kernel(cfg, scene, vis) is kernel


def _old_ndc(H, W, row0=0, height=None):
    """resolve_gbuffer's pixel centres as it wrote them before the
    kernel."""
    height = H if height is None else height
    x_ndc = ((torch.arange(W, dtype=torch.float32) + 0.5) / W
             * 2.0 - 1.0)[None, :].expand(H, W)
    y_ndc = (1.0 - pixel_rows(H, "cpu", row0, height) * 2.0)[:, None].expand(
        H, W)
    return x_ndc, y_ndc


def _words(t):
    return t.contiguous().view(torch.int32)


def _assert_fields(got, want):
    assert set(got) == set(dense_op.FIELDS)
    want = dict(want)
    want["normal_uv"] = torch.stack([want["packed_n"], want["packed_uv"]],
                                    dim=-1)
    for k in dense_op.FIELDS:
        assert got[k].shape == want[k].shape and got[k].dtype == \
            want[k].dtype, k
        assert torch.equal(_words(got[k]), _words(want[k])), k


def _default_vis(cases, name):
    c = case_of(cases, name)
    vis = port_vis(c)
    # the dense path: the alpha scene's winners without their runner-up
    return c, VisBuffer(tri_id=vis.tri_id, depth=vis.depth,
                        resolve_rec=vis.resolve_rec, overflow=vis.overflow)


@pytest.fixture(scope="module")
def cases():
    return {}


@pytest.mark.parametrize("name", ["textured", "nmap", "spheres", "alpha"])
def test_twin_gives_the_dense_pixel_fields(cases, name):
    c, vis = _default_vis(cases, name)
    H, W = vis.depth.shape
    want = t_resolve._pixel_fields(c["ts"], vis, vis.tri_id, vis.depth,
                                   *_old_ndc(H, W))
    n = dense_op.LAUNCHES
    _assert_fields(dense_op.resolve_dense(
        c["ts"], vis, twin=t_resolve.resolve_dense_reference), want)
    assert dense_op.LAUNCHES == n  # the CPU runs the twin
    assert (vis.tri_id < 0).any() and (vis.tri_id >= 0).any()


@pytest.mark.parametrize("name", ["textured", "nmap"])
@pytest.mark.parametrize("a,b", [(0, 17), (23, 64), (40, 41)])
def test_twin_on_a_row_window(cases, name, a, b):
    """Rows [a, b) of the image as a slab of the sharded frame hands them
    (row0=a, height=H): the chain's words on those rows, the window's
    last row its own last row."""
    c, vis = _default_vis(cases, name)
    H, W = vis.depth.shape
    win = VisBuffer(tri_id=vis.tri_id[a:b], depth=vis.depth[a:b],
                    resolve_rec=vis.resolve_rec, overflow=vis.overflow)
    want = t_resolve._pixel_fields(c["ts"], win, win.tri_id, win.depth,
                                   *_old_ndc(b - a, W, a, H))
    _assert_fields(dense_op.resolve_dense(
        c["ts"], win, row0=a, height=H,
        twin=t_resolve.resolve_dense_reference), want)


@pytest.mark.parametrize("name", ["textured", "nmap", "spheres"])
def test_default_frame_resolves_through_resolve_dense(cases, name,
                                                      monkeypatch):
    c, vis = _default_vis(cases, name)
    cfg = port_cfg()
    H, W = vis.depth.shape
    seen = []
    real = dense_op.resolve_dense
    monkeypatch.setattr(
        dense_op, "resolve_dense",
        lambda *a, **k: (seen.append((a, k)), real(*a, **k))[1])
    gb, aux = t_resolve.resolve_gbuffer(c["ts"], vis, cfg)
    assert len(seen) == 1 and seen[0][-1]["twin"] is \
        t_resolve.resolve_dense_reference
    want = t_resolve._pixel_fields(c["ts"], vis, vis.tri_id, vis.depth,
                                   *_old_ndc(H, W))
    wgb, waux = t_resolve._assemble(want, overflow=None)
    for g, w in ((gb.normal_uv, wgb.normal_uv), (gb.material, wgb.material),
                 (gb.depth, wgb.depth), (aux.albedo, waux.albedo),
                 (aux.emissive, waux.emissive), (aux.mr, waux.mr)):
        assert torch.equal(_words(g), _words(w))
    assert aux.overflow is None and aux.cut is None


def test_options_outside_the_envelope_keep_the_chain(cases, monkeypatch):
    """quad_rate_resolve and the alpha scene's runner-up resolve through
    the eager chain, resolve_dense untouched."""
    monkeypatch.setattr(dense_op, "resolve_dense", None)
    c, vis = _default_vis(cases, "textured")
    t_resolve.resolve_gbuffer(c["ts"], vis,
                              port_cfg(quad_rate_resolve=True))
    a = case_of(cases, "alpha")
    t_resolve.resolve_gbuffer(a["ts"], port_vis(a),
                              port_cfg(alpha_mask=True))


@pytest.mark.parametrize("corrupt,name", [
    ("tri_id", "resolve.rec"), ("instance", "resolve.instance"),
    ("idx_start", "resolve.tri_attr")])
def test_bounds_checks_before_the_launch(cases, corrupt, name):
    """The checks the kernel's wrapper makes under debug_bounds name the
    gather the chain would have named."""
    c, vis = _default_vis(cases, "textured")
    dense_op._check_rows(c["ts"], vis)  # a clean frame passes
    tri_id, rec = vis.tri_id.clone(), vis.resolve_rec.clone()
    hit = tri_id >= 0
    if corrupt == "tri_id":
        tri_id = torch.where(hit, tri_id + 10_000_000, tri_id)
    else:
        col = 9 if corrupt == "instance" else 10
        rec[tri_id[hit].long(), col] = 3.0e6
    bad = VisBuffer(tri_id=tri_id, depth=vis.depth, resolve_rec=rec,
                    overflow=vis.overflow)
    with pytest.raises(IndexError, match=name):
        dense_op._check_rows(c["ts"], bad)


def test_tables_taken_as_the_kernel_reads_them():
    t = torch.arange(13 * 12, dtype=torch.float32).reshape(13, 12)
    view = t[1:]  # 48 B past the start: 16-byte aligned
    assert dense_op._table("rec", view, torch.float32, (12,),
                           t.device).data_ptr() == view.data_ptr()
    odd = t.reshape(-1)[1:1 + 12 * 12].reshape(12, 12)
    got = dense_op._table("rec", odd, torch.float32, (12,), t.device)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, odd)
    with pytest.raises(ValueError, match="rec"):
        dense_op._table("rec", t.to(torch.float64), torch.float32, (12,),
                        t.device)
    with pytest.raises(ValueError, match="rec"):
        dense_op._table("rec", t[:, :8], torch.float32, (12,), t.device)


@pytest.mark.parametrize("name,opts", [
    ("textured", {}), ("textured", dict(quad_rate_resolve=True)),
    ("alpha", dict(alpha_mask=True)),
    ("alpha", dict(alpha_mask=True, lazy_alpha_resolve=False))],
    ids=["default", "quad", "alpha_lazy", "alpha_two_pass"])
def test_counters_count_the_pixels_each_path_resolved(cases, name, opts):
    """resolve.kernel_px: the kernel's pixels; resolve.eager_px: each
    dense pass's H x W plus the lazy fallback batch's resolved pixels."""
    from voidin_tpu_torch.framework import profiler

    c = case_of(cases, name)
    vis = port_vis(c) if opts.get("alpha_mask") else _default_vis(cases,
                                                                   name)[1]
    H, W = vis.depth.shape
    profiler.disable()
    profiler.collect()
    profiler.enable()
    try:
        _, aux = t_resolve.resolve_gbuffer(c["ts"], vis, port_cfg(**opts))
    finally:
        profiler.disable()
    got = {}
    for d in profiler.collect():
        for k, v in d["counters"].items():
            got[k] = got.get(k, 0) + v
    if not opts:
        want = {"resolve.kernel_px": H * W}
    elif opts.get("lazy_alpha_resolve") is False:
        want = {"resolve.eager_px": 2 * H * W}
    elif opts.get("alpha_mask"):
        assert int(aux.fallback) > 0
        want = {"resolve.eager_px": H * W + int(aux.fallback)}
    else:
        want = {"resolve.eager_px": H * W}
    assert {k: v for k, v in got.items() if k.startswith("resolve.")} == want
