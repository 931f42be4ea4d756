"""The plain reference renderer of the benchmark: one frame of the port's
pipeline written again in plain PyTorch from the upstream shaders' rules,
as the port's passes state them.

It imports nothing of the program (voidin_tpu_torch), nor JAX, nor the
JAX package, and takes nothing that the program made: it works out again
from the benchmark's scene arrays (pb/scene.py) the moving transforms
(compute_update.wgsl), the cull and LOD select (emit_draws.wgsl), the
mesh pool's corner attributes, the texture mip chain and its quad rows,
the camera uniform and TAA jitter (pb/camera.py), a skinned mesh's
posed vertices (its own linear blend of the scene's rest vertices by the
frame's joint matrices, which pb/animation.py gives both sides), and it
traces shadow rays by brute force over every triangle of every instance
in place of a BVH. The LTC tables are its frozen copy (ltc_tables.npz
beside this file, the upstream fit the program ships as an asset).

Its own rasterizer tests pixel centres against each triangle's three
edge planes and keeps the largest reverse-Z depth: it is written apart
from the port's tiled kernel, so the two may part on pixels exactly on
an edge or at a depth tie, and nowhere else.

`dtype` computes every float of the frame in that type (the precision
control runs it in bfloat16); integer ids and indices stay exact. The
TF32 path of matmul stays off.

Pipeline of Reference.frame, after render_frame (framework/renderer.py):
skin (a skinned scene) -> update -> cull + LOD -> near clip, projection,
back-face cull -> raster (depth + id) -> resolve (barycentrics, normal,
uv, trilinear albedo) -> shade (ambient, point lights, LTC rect lights;
or raytraced point-light shadows) -> TAA (reproject, history resolve) ->
post (sharpen, tonemap) -> sRGB.
"""

from __future__ import annotations

import os

import numpy as np
import torch

LIGHT_MATERIAL = 2
LUT = 64
LUT_SCALE = (LUT - 1.0) / LUT
LUT_BIAS = 0.5 / LUT
_MU = (1 << 16) - 1
_HERE = os.path.dirname(os.path.abspath(__file__))

_YCBCR = np.array([[0.2126, 0.7152, 0.0722], [-0.1146, -0.3854, 0.5],
                   [0.5, -0.4542, -0.0458]], np.float32)
_YCBCR_INV = np.array([[1.0, 0.0, 1.5748], [1.0, -0.1873, -0.4681],
                       [1.0, 1.8556, 0.0]], np.float32)


# ---------------------------------------------------------------------------
# small vector helpers (explicit sums, no matmul)
# ---------------------------------------------------------------------------

def dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v, eps=1e-20):
    return v / torch.sqrt(torch.clamp(dot3(v, v), min=eps))[..., None]


def mat3_vec(m, v):
    return torch.stack([dot3(m[..., i, :], v) for i in range(3)], -1)


def const_mat_vec(m, v):
    return torch.stack([float(m[i, 0]) * v[..., 0] + float(m[i, 1]) * v[..., 1]
                        + float(m[i, 2]) * v[..., 2] for i in range(3)], -1)


def luma(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.clamp(c, min=1e-10) ** (1 / 2.4) - 0.055)


def oct_encode_np(n):
    """encoding.wgsl:4-15 on the host: (..., 3) -> (...,) u32 words."""
    n = np.asarray(n, np.float32)
    s = np.abs(n[..., 0]) + np.abs(n[..., 1]) + np.abs(n[..., 2])
    nor = n / np.maximum(s[..., None], 1e-20)
    xy = (1.0 - np.abs(nor[..., [1, 0]])) * np.sign(nor[..., :2])
    v = np.where((nor[..., 2] < 0.0)[..., None], xy, nor[..., :2]) * 0.5 + 0.5
    d = np.floor(v * np.float32(_MU) + 0.5).astype(np.int64)
    return (d[..., 1] << 16) | d[..., 0]


def oct_encode(n):
    """encoding.wgsl:4-15: (..., 3) -> (...,) i64 words."""
    s = n[..., 0].abs() + n[..., 1].abs() + n[..., 2].abs()
    nor = n / s[..., None]
    xy = (1.0 - nor[..., [1, 0]].abs()) * torch.sign(nor[..., :2])
    v = torch.where((nor[..., 2] < 0.0)[..., None], xy, nor[..., :2]) * 0.5 + 0.5
    d = torch.floor(v * float(_MU) + 0.5).to(torch.int64)
    return (d[..., 1] << 16) | d[..., 0]


def oct_decode(words, dtype):
    """encoding.wgsl:17-28: i64 words -> (..., 3) unit normals."""
    d = torch.stack([words & _MU, (words >> 16) & _MU], -1).to(dtype)
    v = d / float(_MU) * 2.0 - 1.0
    z = 1.0 - v[..., 0].abs() - v[..., 1].abs()
    t = torch.clamp(-z, min=0.0)
    x = v[..., 0] + torch.where(v[..., 0] > 0.0, -t, t)
    y = v[..., 1] + torch.where(v[..., 1] > 0.0, -t, t)
    nor = torch.stack([x, y, z], -1)
    return nor / torch.sqrt(dot3(nor, nor))[..., None]


def shift(img, dy, dx):
    """Edge-clamped shift: out[y, x] = img[y + dy, x + dx]."""
    H, W = img.shape[:2]
    ys = torch.clamp(torch.arange(H, device=img.device) + dy, 0, H - 1)
    xs = torch.clamp(torch.arange(W, device=img.device) + dx, 0, W - 1)
    return img[ys][:, xs]


def smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def mitchell(x):
    B = C = 1.0 / 3.0
    ax = abs(float(x))
    if ax < 1.0:
        return ((12 - 9 * B - 6 * C) * ax ** 3 + (-18 + 12 * B + 6 * C) * ax ** 2
                + (6 - 2 * B)) / 6.0
    if ax < 2.0:
        return ((-B - 6 * C) * ax ** 3 + (6 * B + 30 * C) * ax ** 2
                + (-12 * B - 48 * C) * ax + (8 * B + 24 * C)) / 6.0
    return 0.0


# ---------------------------------------------------------------------------
# textures: box-filtered mip chain, each level's texels and the parent
# level resampled onto them, as u8; trilinear = bilinear in both, blended
# ---------------------------------------------------------------------------

def _down2(img):
    h, w = img.shape[:2]
    if h == 1 and w == 1:
        return img
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    if h > 1 and w > 1:
        return img[:nh * 2, :nw * 2].reshape(nh, 2, nw, 2, -1).mean(axis=(1, 3))
    if h == 1:
        return img[:, :nw * 2].reshape(1, nw, 2, -1).mean(axis=2)
    return img[:nh * 2].reshape(nh, 2, 1, -1).mean(axis=1)


def _resample(parent, ch, cw):
    """The parent level bilinearly sampled at the child's texel centres
    (clamped)."""
    ph, pw = parent.shape[:2]
    if (ph, pw) == (ch, cw):
        return parent
    py = np.clip((np.arange(ch) + 0.5) * ph / ch - 0.5, 0, ph - 1)
    px = np.clip((np.arange(cw) + 0.5) * pw / cw - 0.5, 0, pw - 1)
    y0, x0 = np.floor(py).astype(int), np.floor(px).astype(int)
    y1, x1 = np.minimum(y0 + 1, ph - 1), np.minimum(x0 + 1, pw - 1)
    ty = (py - y0)[:, None, None]
    tx = (px - x0)[None, :, None]
    a = parent[y0][:, x0] * (1 - tx) + parent[y0][:, x1] * tx
    b = parent[y1][:, x0] * (1 - tx) + parent[y1][:, x1] * tx
    return a * (1 - ty) + b * ty


class Textures:
    """Every texture's levels, child and parent-resampled texels (u8 as
    floats / 255), flattened into one table on the device."""

    MAX_LEVELS = 16

    def __init__(self, textures, device, dtype):
        rows, offs, dims = [], [], []
        n = 0
        for img, _ in textures:
            levels = [img.astype(np.float32)]
            while min(levels[-1].shape[0], levels[-1].shape[1]) > 1:
                levels.append(_down2(levels[-1]))
            o, d = [], []
            for li, level in enumerate(levels):
                lh, lw = level.shape[:2]
                parent = levels[min(li + 1, len(levels) - 1)]
                child_u8 = (level + 0.5).astype(np.uint8)
                par_u8 = (_resample(parent, lh, lw) + 0.5).astype(np.uint8)
                rows.append(np.concatenate([child_u8, par_u8], -1)
                            .reshape(lh * lw, 8))
                o.append(n)
                d.append((lw, lh))
                n += lh * lw
            while len(o) < self.MAX_LEVELS:
                o.append(o[-1])
                d.append(d[-1])
            offs.append(o)
            dims.append(d)
        table = np.concatenate(rows).astype(np.float32) * np.float32(1.0 / 255.0)
        self.table = torch.as_tensor(table, device=device).to(dtype)
        self.offs = torch.as_tensor(np.asarray(offs, np.int64), device=device)
        dims = np.asarray(dims, np.int64)
        self.lw = torch.as_tensor(dims[..., 0], device=device)
        self.lh = torch.as_tensor(dims[..., 1], device=device)
        self.size = torch.as_tensor(dims[:, 0, :], device=device)  # (T, 2) w, h

    def sample(self, tex, uv, lod):
        """Trilinear, repeat wrap, raw (source-encoded) rgba."""
        w0 = self.size[tex, 0]
        h0 = self.size[tex, 1]
        max_lod = torch.floor(torch.log2(
            torch.clamp(torch.minimum(w0, h0).to(torch.float32), min=1.0) + 0.5))
        lod = torch.minimum(torch.clamp(lod, min=0.0), max_lod.to(lod.dtype))
        l0f = torch.floor(lod)
        frac = (lod - l0f)[..., None]
        l0 = torch.clamp(torch.nan_to_num(l0f), 0,
                         self.MAX_LEVELS - 1).to(torch.int64)
        lw = self.lw[tex, l0]
        lh = self.lh[tex, l0]
        off = self.offs[tex, l0]
        fx = uv[..., 0] * lw.to(uv.dtype) - 0.5
        fy = uv[..., 1] * lh.to(uv.dtype) - 0.5
        x0f, y0f = torch.floor(fx), torch.floor(fy)
        tx = (fx - x0f)[..., None]
        ty = (fy - y0f)[..., None]
        x0 = torch.remainder(x0f.to(torch.int64), lw)
        y0 = torch.remainder(y0f.to(torch.int64), lh)
        x1 = torch.remainder(x0 + 1, lw)
        y1 = torch.remainder(y0 + 1, lh)
        c00 = self.table[off + y0 * lw + x0]
        c10 = self.table[off + y0 * lw + x1]
        c01 = self.table[off + y1 * lw + x0]
        c11 = self.table[off + y1 * lw + x1]
        top = c00 + (c10 - c00) * tx
        bot = c01 + (c11 - c01) * tx
        q = top + (bot - top) * ty
        child, parent = q[..., :4], q[..., 4:]
        return child + (parent - child) * frac


# ---------------------------------------------------------------------------
# LTC rect lights (utils/ltc.wgsl)
# ---------------------------------------------------------------------------

def _taps(f):
    i0f = torch.clamp(torch.floor(f), 0, LUT - 1)
    t = f - i0f
    i0 = torch.nan_to_num(i0f, nan=0.0).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=LUT - 1)
    same = i1 == i0
    w0 = torch.where(same, (1.0 - t) + t, 1.0 - t)
    w1 = torch.where(same, torch.zeros_like(t), t)
    return i0, i1, w0, w1


def lut_fetch(tables, uv):
    """Clamped bilinear 64x64 fetch, rows first, of each (64, 64) table."""
    fx = uv[..., 0] * LUT - 0.5
    fy = uv[..., 1] * LUT - 0.5
    x0, x1, wx0, wx1 = _taps(fx)
    y0, y1, wy0, wy1 = _taps(fy)
    out = []
    for t in tables:
        flat = t.reshape(-1)
        r0 = wy0 * flat[y0 * LUT + x0] + wy1 * flat[y1 * LUT + x0]
        r1 = wy0 * flat[y0 * LUT + x1] + wy1 * flat[y1 * LUT + x1]
        out.append(wx0 * r0 + wx1 * r1)
    return out


def integrate_edge(v1, v2):
    x = dot3(v1, v2)
    y = x.abs()
    a = 0.8543985 + (0.4965155 + 0.0145206 * y) * y
    b = 3.4175940 + (4.1616724 + y) * y
    v = a / b
    ts = torch.where(x > 0.0, v,
                     0.5 / torch.sqrt(torch.clamp(1.0 - x * x, min=1e-7)) - v)
    return cross3(v1, v2) * ts[..., None]


def ltc_rect(ltc2, nor, view, pos, mminv, points):
    t1 = normalize(view - nor * dot3(view, nor)[..., None])
    t2 = cross3(nor, t1)
    basis = torch.stack([t1, t2, nor], -2)
    minv = torch.stack([torch.stack([dot3(mminv[..., i, :], basis[..., :, j])
                                     for j in range(3)], -1)
                        for i in range(3)], -2)
    L = [normalize(mat3_vec(minv, points[p] - pos)) for p in range(4)]
    direction = points[0] - pos
    light_n = cross3(points[1] - points[0], points[3] - points[0])
    behind = dot3(direction, light_n.expand_as(direction)) < 0.0
    vsum = (integrate_edge(L[0], L[1]) + integrate_edge(L[1], L[2])
            + integrate_edge(L[2], L[3]) + integrate_edge(L[3], L[0]))
    length = torch.sqrt(dot3(vsum, vsum))
    z = vsum[..., 2] / torch.clamp(length, min=1e-20)
    z = torch.where(behind, -z, z)
    uv = torch.stack([z * 0.5 + 0.5, length], -1) * LUT_SCALE + LUT_BIAS
    scale = lut_fetch([ltc2[..., 3]], uv)[0]
    return torch.where(behind, 0.0, length * scale)


def attenuation(max_intensity, falloff, dist, radius):
    s = dist / radius
    s2 = s * s
    one = 1.0 - s2
    att = max_intensity * (one * one) / (1.0 + falloff * s2)
    return torch.where(s >= 1.0, 0.0, att)


def pow16(x):
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    return x8 * x8


def ycbcr(c):
    return const_mat_vec(_YCBCR, c)


def ycbcr_inv(c):
    return const_mat_vec(_YCBCR_INV, c)


# ---------------------------------------------------------------------------
# the frame
# ---------------------------------------------------------------------------

class Reference:
    """The reference renderer of one configuration's scene."""

    def __init__(self, scene, config, device, dtype=torch.float32,
                 chunk=1 << 23):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dev = torch.device(device)
        self.ft = dtype
        self.chunk = chunk
        r = config["renderer"]
        self.cull = bool(r["enable_cull"])
        self.taa = bool(r["enable_taa"])
        self.post = bool(r["enable_post"])
        self.rt = bool(r["enable_rt_shadows"])
        if r["rt_shadow_scale"] != 1 or r["area_light_scale"] != 1:
            raise ValueError("the reference renders full-rate shading only")
        self.W, self.H = int(config["width"]), int(config["height"])
        dev, ft = self.dev, dtype

        def f(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev).to(ft)

        # mesh pool: per triangle its corners, corner uvs and normals (the
        # pool stores normals as oct32 words: decoded here from the same
        # words), triangles of mesh m at [base[m], base[m] + count[m])
        pos, uvs, nrm, base, count, mn, mx = [], [], [], [], [], [], []
        n = 0
        for m in scene.meshes:
            tri = m.indices.reshape(-1, 3)
            pos.append(m.vertices[tri])
            uvs.append(m.uvs[tri])
            nrm.append(oct_encode_np(m.normals[tri]))
            base.append(n)
            count.append(tri.shape[0])
            n += tri.shape[0]
            mn.append(m.vertices.min(0))
            mx.append(m.vertices.max(0))
        self.tri_pos = f(np.concatenate(pos))  # (T, 3, 3)
        self.tri_uv = f(np.concatenate(uvs))  # (T, 3, 2)
        self.tri_n = oct_decode(torch.as_tensor(np.concatenate(nrm),
                                                device=dev), ft)
        self.mesh_base = torch.as_tensor(base, device=dev)
        self.mesh_count = torch.as_tensor(count, device=dev)
        self.mesh_min, self.mesh_max = f(np.stack(mn)), f(np.stack(mx))
        # skinned meshes: rest vertices, normals and triangles, each
        # vertex's rows of the frame's joint matrices (the skins' joint
        # lists concatenated in order) and its weights, normalised
        self.rest = (self.tri_pos, self.tri_n, self.mesh_min, self.mesh_max)
        self.skins = []
        row = 0
        for sk in scene.skins:
            m = scene.meshes[sk.mesh]
            w = np.asarray(sk.weights, np.float32)
            wsum = w.sum(-1, keepdims=True)
            if not (wsum > 0.0).all():
                raise ValueError("a skinned vertex has no weight")
            self.skins.append(dict(
                mesh=sk.mesh, v=f(m.vertices), n=f(m.normals),
                tri=torch.as_tensor(m.indices.reshape(-1, 3).astype(np.int64),
                                    device=dev),
                rows=torch.as_tensor(row + np.asarray(sk.joints, np.int64),
                                     device=dev),
                w=f(w / wsum)))
            row += len(sk.joint_list)
        n_mesh = len(scene.meshes)
        table = np.full((n_mesh, 4), -1, np.int64)
        thresh = np.zeros((n_mesh, 4), np.float32)
        table[:, 0] = np.arange(n_mesh)
        for b, lods in scene.lods.items():
            for k, (mid, ratio) in enumerate(lods):
                table[b, k + 1] = mid
                thresh[b, k + 1] = ratio
        self.has_lods = bool(scene.lods)
        self.lod_table = torch.as_tensor(table, device=dev)
        self.lod_thresh = f(thresh)

        self.tex = Textures(scene.textures, dev, ft)
        mats = scene.materials
        self.mat_albedo = torch.as_tensor([m["albedo"] for m in mats],
                                          device=dev)
        self.mat_alpha = f([m["base_color"][3] for m in mats])
        if any(m["normal"] != 0 for m in mats):
            raise ValueError("the reference has no normal maps")

        def const(tid):
            img, srgb = scene.textures[tid]
            if img.shape[:2] != (1, 1):
                raise ValueError("the reference takes 1x1 emissive and "
                                 "metallic-roughness textures")
            v = img[0, 0].astype(np.float32) / 255.0
            if srgb:
                c = v[:3]
                v = np.concatenate([np.where(c <= 0.04045, c / 12.92,
                                             ((c + 0.055) / 1.055) ** 2.4),
                                    v[3:]])
            return v.astype(np.float32)

        self.mat_emissive = f([const(m["emissive"])[:3] for m in mats])
        self.mat_mr = f([const(m["metallic_roughness"]) for m in mats])
        # one sRGB decode flag for every albedo (textures of only 0 and 255
        # are fixed points of the decode and do not count)
        flags = {scene.textures[m["albedo"]][1] for m in mats
                 if not np.isin(scene.textures[m["albedo"]][0], (0, 255)).all()}
        if len(flags) > 1:
            raise ValueError("mixed sRGB flags among albedo textures")
        self.albedo_srgb = flags.pop() if flags else False

        T, mesh_ids, mat_ids = scene.arrays()
        self.T0 = torch.as_tensor(T, device=dev)  # f32: updated in f32
        self.inst_mesh = torch.as_tensor(mesh_ids.astype(np.int64), device=dev)
        self.inst_mat = torch.as_tensor(mat_ids.astype(np.int64), device=dev)
        self.moving = torch.as_tensor(scene.moving.astype(np.int64), device=dev)
        self.points = [(f(p), float(r), f(c)) for p, r, c in scene.point_lights]
        self.areas = [(f(c), float(i), f(p)) for c, i, p in scene.area_lights]
        ltc = np.load(os.path.join(_HERE, "ltc_tables.npz"))
        self.ltc1, self.ltc2 = f(ltc["ltc1"]), f(ltc["ltc2"])
        self._T = (0, self.T0.clone(), 0.0)  # (next frame, transforms, time)

    # -- skinning: linear blend per vertex ----------------------------------
    def posed(self, joint_mats):
        """(tri_pos, tri_n, mesh_min, mesh_max) of the mesh pool posed by
        `joint_mats` ((J, 4, 4), every skin's rows): each skinned vertex at
        sum_k w_k M_k [v; 1], its normal normalize(sum_k w_k R_k n) read
        at the pool's precision (oct32 words), de-indexed into its mesh's
        triangle rows, and the mesh's box taken from the posed vertices.
        Other meshes keep their rest rows."""
        jm = torch.as_tensor(np.asarray(joint_mats, np.float32),
                             device=self.dev).to(self.ft)
        tri_pos, tri_n, mn, mx = (x.clone() for x in self.rest)
        for sk in self.skins:
            M = jm[sk["rows"]]  # (V, 4, 4, 4)
            w = sk["w"]
            pos = torch.zeros_like(sk["v"])
            nrm = torch.zeros_like(sk["n"])
            for k in range(4):
                R = M[:, k, :3, :3]
                pos = pos + w[:, k, None] * (mat3_vec(R, sk["v"])
                                             + M[:, k, :3, 3])
                nrm = nrm + w[:, k, None] * mat3_vec(R, sk["n"])
            nrm = oct_decode(oct_encode(normalize(nrm)), self.ft)
            b = int(self.mesh_base[sk["mesh"]])
            c = int(self.mesh_count[sk["mesh"]])
            tri_pos[b:b + c] = pos[sk["tri"]]
            tri_n[b:b + c] = nrm[sk["tri"]]
            mn[sk["mesh"]] = pos.amin(0)
            mx[sk["mesh"]] = pos.amax(0)
        return tri_pos, tri_n, mn, mx

    # -- update (compute_update.wgsl:12-28) --------------------------------
    def transforms(self, frame, dt):
        """Instance transforms as frame `frame` renders them: each moving
        instance turned by Rz(speed * dt) once a frame from frame 0 on,
        speed = +-2 sin(0.5 t), in f32."""
        k, T, time = self._T
        if frame + 1 < k:
            k, T, time = 0, self.T0.clone(), 0.0
        ids = self.moving
        dt32 = torch.tensor(float(np.float32(dt)), dtype=torch.float32,
                            device=self.dev)
        while k <= frame:
            if ids.numel():
                t = T[ids]
                tt = torch.tensor(float(np.float32(time)), dtype=torch.float32,
                                  device=self.dev)
                speed = 2.0 * torch.sin(tt * 0.5)
                sign = torch.where(t[:, 2, 3] > -15.0, 1.0, -1.0)
                ang = speed * sign * dt32
                c, s = torch.cos(ang), torch.sin(ang)
                rz = torch.zeros(ids.numel(), 4, 4, device=self.dev)
                rz[:, 0, 0], rz[:, 0, 1], rz[:, 1, 0], rz[:, 1, 1] = c, -s, s, c
                rz[:, 2, 2] = 1.0
                rz[:, 3, 3] = 1.0
                T[ids] = torch.matmul(rz, t)
            time += dt
            k += 1
        self._T = (k, T, time)
        return T

    # -- cull + LOD (emit_draws.wgsl:14-35) ---------------------------------
    def draws(self, T, cam):
        ft = self.ft
        view = torch.as_tensor(cam.view, device=self.dev).to(ft)
        Tf = T.to(ft)
        mesh = self.inst_mesh
        mn, mx = self.mesh_min[mesh], self.mesh_max[mesh]
        c_obj = (mn + mx) * 0.5
        vm = torch.matmul(view, Tf)
        center = mat3_vec(vm[:, :3, :3], c_obj) + vm[:, :3, 3]
        basis = Tf[:, :3, :3]
        scale = torch.sqrt((basis * basis).sum(-2))
        radius = torch.sqrt(dot3((mx - mn) * 0.5, (mx - mn) * 0.5)) \
            * scale.abs().amax(-1)
        fr = [float(v) for v in cam.frustum]
        vis = torch.ones_like(radius, dtype=torch.bool)
        if self.cull:
            vis = ((center[:, 2] * fr[1] - center[:, 0].abs() * fr[0] >= -radius)
                   & (center[:, 2] * fr[3] - center[:, 1].abs() * fr[2] >= -radius))
        sel = mesh
        if self.has_lods:
            ratio = torch.sqrt(dot3(center, center)) / torch.clamp(radius, min=1e-6)
            table = self.lod_table[mesh]
            th = self.lod_thresh[mesh]
            level = ((table[:, 1:] >= 0) & (ratio[:, None] >= th[:, 1:])).sum(-1)
            sel = torch.gather(table, 1, level[:, None])[:, 0]
        inst = torch.nonzero(vis).flatten()
        return inst, sel[inst]

    # -- setup: clip, near clip, project, back-face cull ---------------------
    def setup(self, T, cam, inst, mesh):
        ft, W, H = self.ft, self.W, self.H
        cnt = self.mesh_count[mesh]
        tri_inst = torch.repeat_interleave(inst, cnt)
        first = torch.cumsum(cnt, 0) - cnt
        local = torch.arange(int(cnt.sum()), device=self.dev) \
            - torch.repeat_interleave(first, cnt)
        tri = torch.repeat_interleave(self.mesh_base[mesh], cnt) + local
        pv = torch.as_tensor(cam.projection, device=self.dev).to(ft) @ \
            torch.as_tensor(cam.view, device=self.dev).to(ft)
        mvp = torch.matmul(pv, T.to(ft))  # (N, 4, 4)
        m = mvp[tri_inst]  # (n, 4, 4)
        p = self.tri_pos[tri]  # (n, 3, 3)
        clip = torch.stack([dot3(m[:, None, i, :3], p) + m[:, None, i, 3]
                            for i in range(4)], -1)  # (n, 3, 4)
        s = clip[..., 3] - clip[..., 2]
        inside = s > 0.0
        n_in = inside.sum(-1)
        r1 = torch.argmax(inside.to(torch.uint8), -1)
        r2 = (torch.argmax((~inside).to(torch.uint8), -1) + 1) % 3
        r = torch.where(n_in == 1, r1, torch.where(n_in == 2, r2, 0))
        order = (r[:, None] + torch.arange(3, device=self.dev)[None]) % 3
        rc = torch.gather(clip, 1, order[..., None].expand(-1, -1, 4))
        a, b, c = rc[:, 0], rc[:, 1], rc[:, 2]

        def cut(pp, qq):
            sp = pp[..., 3] - pp[..., 2]
            sq = qq[..., 3] - qq[..., 2]
            den = sp - sq
            t = sp / torch.where(den.abs() > 1e-20, den, 1e-20)
            return pp + (qq - pp) * t[..., None]

        i_ab, i_ac, i_bc = cut(a, b), cut(a, c), cut(b, c)
        tri1 = torch.where((n_in == 3)[:, None, None], clip,
                           torch.where((n_in == 2)[:, None, None],
                                       torch.stack([a, b, i_bc], 1),
                                       torch.stack([a, i_ab, i_ac], 1)))
        tri2 = torch.stack([a, i_bc, i_ac], 1)
        alpha_ok = self.mat_alpha[self.inst_mat[tri_inst]] >= 0.5
        two = (n_in == 2) & alpha_ok
        polys = torch.cat([tri1, tri2[two]])
        src = torch.cat([torch.arange(tri.shape[0], device=self.dev),
                         torch.nonzero(two).flatten()])
        ok = torch.cat([(n_in >= 1) & alpha_ok, torch.ones(int(two.sum()),
                                                           dtype=torch.bool,
                                                           device=self.dev)])
        w = polys[..., 3]
        inv_w = 1.0 / torch.where(w.abs() > 1e-8, w, 1e-8)
        sx = (polys[..., 0] * inv_w * 0.5 + 0.5) * W
        sy = (0.5 - polys[..., 1] * inv_w * 0.5) * H
        sz = polys[..., 2] * inv_w
        area2 = (sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0]) \
            - (sy[:, 1] - sy[:, 0]) * (sx[:, 2] - sx[:, 0])
        finite = (torch.isfinite(sx) & torch.isfinite(sy)
                  & torch.isfinite(sz)).all(-1)
        alive = ok & (area2 < 0.0) & finite
        keep = torch.nonzero(alive).flatten()
        return dict(sx=sx[keep], sy=sy[keep], sz=sz[keep], src=src[keep],
                    tri=tri, tri_inst=tri_inst,
                    clip=clip[..., [0, 1, 3]])

    # -- raster: the largest reverse-Z depth at each pixel centre -------------
    def raster(self, st):
        W, H = self.W, self.H
        sx, sy, sz = st["sx"], st["sy"], st["sz"]
        ax0 = torch.floor(sx.amin(-1))
        ay0 = torch.floor(sy.amin(-1))
        rx = sx - ax0[:, None]
        ry = sy - ay0[:, None]
        nxt = [1, 2, 0]
        dx = rx[:, nxt] - rx
        dy = ry[:, nxt] - ry
        ex_a, ey_a = dy, -dx
        eb = ry * dx - rx * dy
        area2 = dy[:, 0] * dx[:, 1] - dx[:, 0] * dy[:, 1]
        inv = 1.0 / torch.where(area2.abs() > 1e-20, area2, 1e-20)
        zr = sz[:, [2, 0, 1]]
        dza = (ex_a * zr).sum(-1) * inv
        dzb = (ey_a * zr).sum(-1) * inv
        dzc = (eb * zr).sum(-1) * inv
        zmax = sz.amax(-1)
        # the pixel centres inside each bounding box, as exact integers
        # (a narrow float type cannot hold every column index)
        f32 = torch.float32
        x0i = torch.clamp(torch.ceil(sx.amin(-1).to(f32) - 0.5), 0, W)
        x1i = torch.clamp(torch.floor(sx.amax(-1).to(f32) - 0.5), -1, W - 1)
        y0i = torch.clamp(torch.ceil(sy.amin(-1).to(f32) - 0.5), 0, H)
        y1i = torch.clamp(torch.floor(sy.amax(-1).to(f32) - 0.5), -1, H - 1)
        x0i, x1i, y0i, y1i = (v.to(torch.int64) for v in (x0i, x1i, y0i, y1i))
        nx = torch.clamp(x1i - x0i + 1, min=0)
        ny = torch.clamp(y1i - y0i + 1, min=0)
        nx = torch.where(ny > 0, nx, 0)
        ny = torch.where(nx > 0, ny, 0)
        n = nx * ny
        best = torch.full((H * W,), -1, dtype=torch.int64, device=self.dev)
        cum = torch.cumsum(n, 0)
        total = int(cum[-1]) if n.numel() else 0
        start_t = 0
        while start_t < n.numel():
            # the triangles whose candidates fit one chunk (at least one)
            base = int(cum[start_t - 1]) if start_t else 0
            end_t = int(torch.searchsorted(cum, base + self.chunk, right=True))
            end_t = max(end_t, start_t + 1)
            sl = slice(start_t, end_t)
            cnt = n[sl]
            m = int(cnt.sum())
            start_t = end_t
            if m == 0:
                continue
            t = torch.repeat_interleave(torch.arange(sl.start, sl.stop,
                                                     device=self.dev), cnt)
            off = torch.arange(m, device=self.dev) \
                - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
            px = x0i[t] + off % nx[t]
            py = y0i[t] + off // nx[t]
            cx = (px.to(self.ft) + 0.5) - ax0[t]
            cy = (py.to(self.ft) + 0.5) - ay0[t]
            inside = torch.ones(m, dtype=torch.bool, device=self.dev)
            for k in range(3):
                e = (ex_a[t, k] * cx + ey_a[t, k] * cy) + eb[t, k]
                inside &= e >= 0.0
            d = torch.minimum((dza[t] * cx + dzb[t] * cy) + dzc[t], zmax[t])
            inside &= d > 0.0
            d32 = d.to(torch.float32)
            key = (d32.view(torch.int32).to(torch.int64) << 31) | t
            key = torch.where(inside, key, -1)
            best.scatter_reduce_(0, py * W + px, key, "amax")
        del total
        hit = best >= 0
        tid = torch.where(hit, best & ((1 << 31) - 1), 0)
        depth = torch.where(hit, (best >> 31).to(torch.int32).view(
            torch.float32), 0.0).to(self.ft)
        return hit.reshape(H, W), tid.reshape(H, W), depth.reshape(H, W)

    # -- resolve (visibility.wgsl:66-97) --------------------------------------
    def resolve(self, st, T, hit, tid, depth):
        ft, W, H, dev = self.ft, self.W, self.H, self.dev
        src = st["src"][tid]  # original triangle of each pixel's winner
        cl = st["clip"][src]  # (H, W, 3, 3): clip x, y, w per corner
        tri = st["tri"][src]
        inst = st["tri_inst"][src]
        u = (torch.arange(W, device=dev, dtype=ft) + 0.5) / W
        v = (torch.arange(H, device=dev, dtype=ft) + 0.5) / H
        xn = (u * 2.0 - 1.0)[None, :].expand(H, W)
        yn = ((1.0 - v) * 2.0 - 1.0)[:, None].expand(H, W)
        uu = cl[..., 0] - xn[..., None] * cl[..., 2]
        vv = cl[..., 1] - yn[..., None] * cl[..., 2]
        bc = cross3(uu, vv)
        bsum = bc.sum(-1, keepdim=True)
        sign = torch.where(bsum < 0, -1.0, 1.0)
        lam = bc * sign / torch.clamp(bsum * sign, min=1e-20)
        uv = (self.tri_uv[tri] * lam[..., None]).sum(-2)
        n_obj = (self.tri_n[tri] * lam[..., None]).sum(-2)
        basis = T[inst][..., :3, :3].to(ft)
        n_ws = normalize(mat3_vec(basis, n_obj))
        mat = self.inst_mat[inst]
        atex = self.mat_albedo[mat]
        tex_w = self.tex.size[atex, 0].to(ft)
        tex_h = self.tex.size[atex, 1].to(ft)
        uv = torch.where(hit[..., None], uv, 0.0)
        du = torch.cat([uv[:, 1:] - uv[:, :-1], torch.zeros_like(uv[:, :1])], 1)
        dv = torch.cat([uv[1:] - uv[:-1], torch.zeros_like(uv[:1])], 0)
        rho = torch.maximum(du[..., 0].abs() * tex_w + du[..., 1].abs() * tex_h,
                            dv[..., 0].abs() * tex_w + dv[..., 1].abs() * tex_h)
        lod = torch.clamp(torch.log2(torch.clamp(rho, min=1e-8)), 0.0, 16.0)
        raw = self.tex.sample(atex, uv, lod)
        rgb = srgb_to_linear(raw[..., :3]) if self.albedo_srgb else raw[..., :3]
        albedo = torch.cat([rgb, raw[..., 3:]], -1)
        keep = hit & ~((self.mat_alpha[mat] < 0.5) | (albedo[..., 3] < 0.5))
        words = torch.where(keep, oct_encode(n_ws), 0)
        return dict(
            normal=oct_decode(words, ft),
            material=torch.where(keep, mat, 0),
            depth=torch.where(keep, depth, 0.0),
            albedo=torch.where(keep[..., None], albedo, 1.0),
            emissive=torch.where(keep[..., None], self.mat_emissive[mat],
                                 self.mat_emissive[0]),
            mr=torch.where(keep[..., None], self.mat_mr[mat], self.mat_mr[0]),
        )

    def world_pos(self, depth, cam):
        ft, W, H, dev = self.ft, self.W, self.H, self.dev
        u = (torch.arange(W, device=dev, dtype=ft) + 0.5) / W
        v = (torch.arange(H, device=dev, dtype=ft) + 0.5) / H
        xn = (u * 2.0 - 1.0)[None, :].expand(H, W)
        yn = ((1.0 - v) * 2.0 - 1.0)[:, None].expand(H, W)
        m = cam.clip_to_world
        p = [float(m[i, 0]) * xn + float(m[i, 1]) * yn + float(m[i, 2]) * depth
             + float(m[i, 3]) for i in range(4)]
        w = torch.where(p[3].abs() > 1e-12, p[3],
                        torch.where(p[3] < 0, -1e-12, 1e-12))[..., None]
        return torch.clamp(torch.stack(p[:3], -1) / w, -1e12, 1e12)

    # -- shade (shading.wgsl:36-118) -----------------------------------------
    def shade(self, gb, cam):
        nor, albedo, em, mr = gb["normal"], gb["albedo"], gb["emissive"], gb["mr"]
        pos = self.world_pos(gb["depth"], cam)
        cam_pos = torch.as_tensor(cam.position, device=self.dev).to(self.ft)
        rd = normalize(cam_pos - pos)
        is_light = (gb["material"] == LIGHT_MATERIAL)[..., None]
        color = torch.where(is_light, albedo[..., :3] + em,
                            albedo[..., :3] * 0.01 + em)
        for lpos, lrad, lcol in self.points:
            lv = lpos - pos
            dist = torch.sqrt(dot3(lv, lv))
            att = attenuation(1.0, 1.0, dist, lrad)
            shade_t = torch.clamp(dot3(nor, normalize(lv)), min=0.0)
            diff = lcol * albedo[..., :3] * (shade_t * att)[..., None]
            covr = torch.clamp(dot3(-rd, nor), min=0.0)
            spec = lcol * (mr[..., 2] * pow16(covr) * att)[..., None]
            contrib = torch.where((dist - lrad > 0.0)[..., None], 0.0, diff + spec)
            color = color + torch.where(is_light, 0.0, contrib)
        if self.areas:
            rough = torch.clamp(mr[..., 0], 0.0, 1.0)
            ndotv = torch.clamp(dot3(nor, rd), 0.0, 1.0)
            uv = torch.stack([rough, torch.sqrt(1.0 - ndotv)], -1) \
                * LUT_SCALE + LUT_BIAS
            t = lut_fetch([self.ltc1[..., c] for c in range(4)]
                          + [self.ltc2[..., 0]], uv)
            z0, o1 = torch.zeros_like(t[0]), torch.ones_like(t[0])
            minv = torch.stack([torch.stack([t[0], z0, t[2]], -1),
                                torch.stack([z0, o1, z0], -1),
                                torch.stack([t[1], z0, t[3]], -1)], -2)
            eye = torch.eye(3, device=self.dev, dtype=self.ft).expand(minv.shape)
            for lcol, inten, pts in self.areas:
                diff = ltc_rect(self.ltc2, nor, rd, pos, eye, pts)
                spec = ltc_rect(self.ltc2, nor, rd, pos, minv, pts) * t[4]
                center = (pts[0] + pts[2]) * 0.5
                dc = center - pos
                att = attenuation(inten, 500.0, torch.sqrt(dot3(dc, dc)), 25.0)
                contrib = (lcol * inten) * ((spec * att)[..., None]
                                            + albedo[..., :3] * diff[..., None])
                color = color + torch.where(is_light, 0.0, contrib)
        return torch.clamp(color, min=0.0)

    # -- raytraced shading (raytraced_shadows.wgsl:58-119) ---------------------
    def occluded(self, T, origins, dirs):
        """Any hit with t in (0, 1) of the rays origins + t dirs, by brute
        force over every triangle of every instance in its object space
        (back faces culled, Moller-Trumbore, det >= 1e-10)."""
        ft = self.ft
        hit = torch.zeros(origins.shape[0], dtype=torch.bool, device=self.dev)
        inv = torch.linalg.inv(T.to(torch.float32)).to(ft) if ft != torch.float32 \
            else torch.as_tensor(np.linalg.inv(T.cpu().numpy()).astype(np.float32),
                                 device=self.dev)
        for i in range(T.shape[0]):
            mesh = int(self.inst_mesh[i])
            m = inv[i]
            o = mat3_vec(m[None, :3, :3], origins) + m[:3, 3]
            d = mat3_vec(m[None, :3, :3], dirs)
            # the mesh's box, widened by 1e-3 of its size, as a cut
            lo_b, hi_b = self.mesh_min[mesh], self.mesh_max[mesh]
            pad = (hi_b - lo_b).abs().amax() * 1e-3 + 1e-6
            inv_d = 1.0 / torch.where(d.abs() > 1e-20, d, 1e-20)
            t1 = (lo_b - pad - o) * inv_d
            t2 = (hi_b + pad - o) * inv_d
            tlo = torch.minimum(t1, t2).amax(-1)
            thi = torch.maximum(t1, t2).amin(-1)
            cand = torch.nonzero((thi >= tlo) & (tlo < 1.0) & (thi > 0.0)
                                 & ~hit).flatten()
            if cand.numel() == 0:
                continue
            b, c = int(self.mesh_base[mesh]), int(self.mesh_count[mesh])
            tp = self.tri_pos[b:b + c]
            v0 = tp[:, 0]
            e1 = tp[:, 1] - v0
            e2 = tp[:, 2] - v0
            step = max(1, (1 << 24) // c)
            for s in range(0, cand.numel(), step):
                r = cand[s:s + step]
                oo = o[r][:, None]
                dd = d[r][:, None]
                uvec = cross3(dd, e2[None])
                det = dot3(e1[None], uvec)
                inv_det = 1.0 / torch.where(det.abs() > 1e-20, det, 1e-20)
                orig = oo - v0[None]
                uu = inv_det * dot3(orig, uvec)
                vvec = cross3(orig, e1[None])
                vv = inv_det * dot3(dd, vvec)
                tt = inv_det * dot3(e2[None], vvec)
                h = ((det >= 1e-10) & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0)
                     & (uu + vv <= 1.0) & (tt > 0.0) & (tt < 1.0)).any(-1)
                hit[r] |= h
        return hit

    def shade_raytraced(self, gb, cam, T):
        nor, albedo, em, mr = gb["normal"], gb["albedo"], gb["emissive"], gb["mr"]
        depth, mat = gb["depth"], gb["material"]
        pos = self.world_pos(depth, cam)
        cam_pos = torch.as_tensor(cam.position, device=self.dev).to(self.ft)
        rd = normalize(cam_pos - pos)
        is_light = mat == LIGHT_MATERIAL
        color = torch.where(is_light[..., None], albedo[..., :3] + em,
                            albedo[..., :3] * 0.3 + em)
        shadable = (depth > 0.0) & ~is_light
        for lpos, lrad, lcol in self.points:
            lv = lpos - pos
            dist = torch.sqrt(dot3(lv, lv))
            ndl = dot3(nor, normalize(lv))
            cov = dot3(-rd, nor)
            needs = shadable & (dist < lrad) & ((ndl > 0.0) | (cov > 0.0))
            idx = torch.nonzero(needs.reshape(-1)).flatten()
            occ = torch.zeros(needs.numel(), dtype=torch.bool, device=self.dev)
            occ[idx] = self.occluded(
                T, (pos + nor * 1e-4).reshape(-1, 3)[idx], lv.reshape(-1, 3)[idx])
            occlusion = torch.where(occ.reshape(needs.shape), 0.5, 1.0)
            att = attenuation(1.0, 1.0, dist, lrad)
            shade_t = torch.clamp(ndl, min=0.0)
            diff = lcol * albedo[..., :3] * shade_t[..., None]
            covr = torch.clamp(cov, min=0.0)
            spec = lcol * (mr[..., 2] * pow16(covr))[..., None]
            contrib = (diff + spec) * (occlusion * att)[..., None]
            color = color + torch.where(shadable[..., None], contrib, 0.0)
        magenta = torch.tensor([1.0, 0.0, 1.0], device=self.dev, dtype=self.ft)
        color = torch.where(((mat == 0) & (depth > 0.0))[..., None], magenta, color)
        return torch.clamp(color, min=0.0)

    # -- TAA (reproject.wgsl:14-38, taa.wgsl:45-103) ---------------------------
    def reproject(self, depth, cam):
        W, H, ft = self.W, self.H, self.ft
        d = depth
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    d = torch.maximum(d, shift(depth, dy, dx))
        pos = self.world_pos(d, cam)
        m = cam.prev_world_to_clip
        px = [float(m[i, 0]) * pos[..., 0] + float(m[i, 1]) * pos[..., 1]
              + float(m[i, 2]) * pos[..., 2] + float(m[i, 3]) for i in range(4)]
        prev_x, prev_y = px[0] / px[3], px[1] / px[3]
        u = (torch.arange(W, device=self.dev, dtype=ft) + 0.5) / W
        v = (torch.arange(H, device=self.dev, dtype=ft) + 0.5) / H
        xn = (u * 2.0 - 1.0)[None, :].expand(H, W)
        yn = ((1.0 - v) * 2.0 - 1.0)[:, None].expand(H, W)
        j, pj = cam.jitter, cam.prev_jitter
        vel_x = (xn + float(j[0])) - (prev_x + float(pj[0]))
        vel_y = (yn + float(j[1])) - (prev_y + float(pj[1]))
        lo_x, hi_x = -1.0 + float(np.float32(1.0 / W)), 1.0 - float(np.float32(1.0 / W))
        lo_y, hi_y = -1.0 + float(np.float32(1.0 / H)), 1.0 - float(np.float32(1.0 / H))
        inb = (prev_x == torch.clamp(prev_x, lo_x, hi_x)) & \
            (prev_y == torch.clamp(prev_y, lo_y, hi_y))
        return vel_x, vel_y, inb.to(ft)

    def taa_resolve(self, color, history, vel_x, vel_y, valid):
        W, H, ft, dev = self.W, self.H, self.ft, self.dev
        u = (torch.arange(W, device=dev, dtype=ft) + 0.5) / W
        v = (torch.arange(H, device=dev, dtype=ft) + 0.5) / H
        hu = u[None, :] - vel_x * 0.5
        hv = v[:, None] + vel_y * 0.5
        # the history as its f16 2x2-texel table (clamp to edge)
        h16 = history.to(torch.float16).to(ft)
        fx, fy = hu * W - 0.5, hv * H - 0.5
        x0f, y0f = torch.floor(fx), torch.floor(fy)
        tx, ty = (fx - x0f)[..., None], (fy - y0f)[..., None]
        x0 = torch.clamp(torch.nan_to_num(x0f.to(torch.float32)), 0,
                         W - 1).to(torch.int64)
        y0 = torch.clamp(torch.nan_to_num(y0f.to(torch.float32)), 0,
                         H - 1).to(torch.int64)
        x1 = torch.clamp(x0 + 1, max=W - 1)
        y1 = torch.clamp(y0 + 1, max=H - 1)
        c00, c10 = h16[y0, x0], h16[y0, x1]
        c01, c11 = h16[y1, x0], h16[y1, x1]
        top = c00 + (c10 - c00) * tx
        bot = c01 + (c11 - c01) * tx
        hist = ycbcr(top + (bot - top) * ty)
        vsum = torch.zeros_like(color)
        vsum2 = torch.zeros_like(color)
        mn_sum = torch.zeros_like(color)
        wsum = mn_wsum = 0.0
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                sh = shift(color, dy, dx)
                ne = ycbcr(sh)
                w = float(np.exp(-3.0 * (dx * dx + dy * dy) / 4.0))
                vsum = vsum + ne * w
                vsum2 = vsum2 + ne * ne * w
                wsum += w
                wt = mitchell(np.sqrt(dx * dx + dy * dy))
                mn_sum = mn_sum + sh * wt
                mn_wsum += wt
        ex, ex2 = vsum / wsum, vsum2 / wsum
        sd = torch.sqrt(torch.clamp(ex2 - ex * ex, min=0.0))
        contrast = sd[..., 0] / (ex[..., 0] + 1e-5)
        hpx, hpy = hu * W, hv * H
        tcd = (0.5 - (hpx - torch.floor(hpx))).abs() + (0.5 - (hpy - torch.floor(hpy))).abs()
        box = 1.0 * (0.5 + 0.5 * smoothstep(-0.1, 0.3, contrast))
        box = box * (0.5 + 0.5 * torch.clamp(1.0 - tcd, 0.0, 1.0))
        center = ycbcr(mn_sum / mn_wsum)
        mid = center + (ex - center) * (box * box)[..., None]
        nmin = mid - sd * (box[..., None] * 1.5)
        nmax = mid + sd * (box[..., None] * 1.5)
        clamped = torch.minimum(torch.maximum(hist, nmin), nmax)
        blend = 1.0 + (1.0 / 12.0 - 1.0) * valid
        cd = torch.minimum((hist[..., 0] - nmin[..., 0]).abs(),
                           (hist[..., 0] - nmax[..., 0]).abs()) \
            / torch.clamp(torch.maximum(hist[..., 0], ex[..., 0]), min=1e-5)
        blend = blend * (0.2 + 0.8 * smoothstep(0.0, 2.0, cd))
        return ycbcr_inv(clamped + (center - clamped) * blend[..., None])

    # -- post (postprocess.wgsl:21-98) ------------------------------------------
    def postprocess(self, color):
        def remap(x):
            return torch.sqrt(torch.clamp(x, min=0.0))

        center = remap(luma(color))
        n_x = remap(luma(shift(color, 0, 1)))
        n_y = remap(luma(shift(color, 1, 0)))
        neigh = torch.zeros_like(center)
        wsum = torch.zeros_like(center)
        for _ in range(2):  # the shader's loop visits the same two taps twice
            wt = torch.clamp(1.0 - 6.0 * ((center - n_x).abs() + (center - n_y).abs()),
                             min=0.0)
            wt = torch.minimum(wt, 0.5 * wt * 1.25)
            neigh = neigh + n_x * wt + n_y * wt
            wsum = wsum + wt * 2.0
        sharp = torch.clamp(center * (wsum + 1.0) - neigh, min=0.0)
        sharp = sharp * sharp
        col = color * torch.clamp(sharp / torch.clamp(luma(color), min=1e-5),
                                  min=0.0)[..., None]

        def curve(x):
            c = x + x * x + 0.5 * x * x * x
            return c / (1.0 + c)

        y = ycbcr(col)
        chroma = torch.sqrt(y[..., 1] * y[..., 1] + y[..., 2] * y[..., 2]) * 2.4
        bt = curve(chroma)
        desat = torch.clamp((bt - 0.7) * 0.8, min=0.0)
        desat = desat * desat
        desat_col = col + (y[..., 0:1] - col) * desat[..., None]
        tm0 = col * torch.clamp(curve(y[..., 0]) / torch.clamp(luma(col), min=1e-5),
                                min=0.0)[..., None]
        tm1 = curve(desat_col)
        return (tm0 + (tm1 - tm0) * (bt * bt)[..., None]) * 0.97

    # -- one frame -------------------------------------------------------------
    def frame(self, frame, cam, dt, history=None, joint_mats=None):
        """The sRGB image of frame `frame` at camera uniform `cam`, and the
        TAA history it leaves. `history`: the (H, W, 3) history the frame
        reads (None on the first frame, which seeds it). `joint_mats`: the
        frame's (J, 4, 4) joint matrices, required where the scene has
        skins; the cull, the raster and the shadow rays see that pose."""
        if self.skins:
            if joint_mats is None:
                raise ValueError("the scene has skins: pass joint_mats")
            (self.tri_pos, self.tri_n, self.mesh_min,
             self.mesh_max) = self.posed(joint_mats)
        T = self.transforms(frame, dt)
        inst, mesh = self.draws(T, cam)
        st = self.setup(T, cam, inst, mesh)
        hit, tid, depth = self.raster(st)
        gb = self.resolve(st, T, hit, tid, depth)
        del st
        if self.rt:
            hdr = self.shade_raytraced(gb, cam, T)
        else:
            hdr = self.shade(gb, cam)
        if self.taa:
            if history is not None:
                vx, vy, valid = self.reproject(gb["depth"], cam)
                hdr = self.taa_resolve(hdr, history.to(self.ft), vx, vy, valid)
            history = hdr
        return self.encode(hdr), history

    def encode(self, hdr):
        """HDR -> the displayed sRGB image: post (when on) and the encode."""
        return linear_to_srgb(self.postprocess(hdr) if self.post else hdr)
