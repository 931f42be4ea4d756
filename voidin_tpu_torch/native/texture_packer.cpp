// Texel-quad mip-chain packer -- the host-side hot loop of texture upload.
//
// The port's copy of voidin_tpu/native/texture_packer.cpp, unchanged in
// what it computes: the same source under the same compiler flags gives the
// JAX package's pool word for word. The C++ twin of the numpy packer in
// voidin_tpu_torch/scene/texture.py (_pack_numpy: _downsample2x2 /
// _upsample_to_child / _quad_rows), exact at fine mip levels and within a
// few u8 steps at the deepest mips (float accumulation order differs from
// numpy's pairwise mean): each texel row stores its own 2x2 bilinear
// neighborhood plus the parent level resampled at this level's texel
// centers, so one 32 B gather serves a full trilinear sample.
//
// Built with bvh_builder.cpp into one library at first use by
// voidin_tpu_torch/native/__init__.py; numpy remains the fallback.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Level {
    std::vector<float> px;  // (h, w, 4) float
    int64_t h, w;
    const float* at(int64_t y, int64_t x) const {
        return px.data() + (y * w + x) * 4;
    }
    float* at(int64_t y, int64_t x) { return px.data() + (y * w + x) * 4; }
};

Level downsample2x2(const Level& in) {
    if (in.h == 1 && in.w == 1) return in;
    Level out;
    out.h = in.h > 1 ? in.h / 2 : 1;
    out.w = in.w > 1 ? in.w / 2 : 1;
    out.px.assign(out.h * out.w * 4, 0.f);
    if (in.h > 1 && in.w > 1) {
        for (int64_t y = 0; y < out.h; ++y)
            for (int64_t x = 0; x < out.w; ++x)
                for (int c = 0; c < 4; ++c)
                    out.at(y, x)[c] =
                        (in.at(2 * y, 2 * x)[c] + in.at(2 * y, 2 * x + 1)[c] +
                         in.at(2 * y + 1, 2 * x)[c] +
                         in.at(2 * y + 1, 2 * x + 1)[c]) *
                        0.25f;
    } else if (in.h == 1) {
        for (int64_t x = 0; x < out.w; ++x)
            for (int c = 0; c < 4; ++c)
                out.at(0, x)[c] =
                    (in.at(0, 2 * x)[c] + in.at(0, 2 * x + 1)[c]) * 0.5f;
    } else {
        for (int64_t y = 0; y < out.h; ++y)
            for (int c = 0; c < 4; ++c)
                out.at(y, 0)[c] =
                    (in.at(2 * y, 0)[c] + in.at(2 * y + 1, 0)[c]) * 0.5f;
    }
    return out;
}

// Bilinearly sample the parent level at the child's texel centers
// (_upsample_to_child — clamped, matching numpy's clip semantics).
Level upsample_to_child(const Level& parent, int64_t ch, int64_t cw) {
    if (parent.h == ch && parent.w == cw) return parent;
    Level out;
    out.h = ch;
    out.w = cw;
    out.px.assign(ch * cw * 4, 0.f);
    for (int64_t y = 0; y < ch; ++y) {
        double py = (y + 0.5) * double(parent.h) / ch - 0.5;
        if (py < 0) py = 0;
        if (py > parent.h - 1) py = double(parent.h - 1);
        int64_t y0 = (int64_t)py;
        int64_t y1 = y0 + 1 < parent.h ? y0 + 1 : parent.h - 1;
        float ty = float(py - y0);
        for (int64_t x = 0; x < cw; ++x) {
            double px = (x + 0.5) * double(parent.w) / cw - 0.5;
            if (px < 0) px = 0;
            if (px > parent.w - 1) px = double(parent.w - 1);
            int64_t x0 = (int64_t)px;
            int64_t x1 = x0 + 1 < parent.w ? x0 + 1 : parent.w - 1;
            float tx = float(px - x0);
            for (int c = 0; c < 4; ++c) {
                float a = parent.at(y0, x0)[c] * (1 - tx) +
                          parent.at(y0, x1)[c] * tx;
                float b = parent.at(y1, x0)[c] * (1 - tx) +
                          parent.at(y1, x1)[c] * tx;
                out.at(y, x)[c] = a * (1 - ty) + b * ty;
            }
        }
    }
    return out;
}

inline uint8_t to_u8(float v) { return (uint8_t)(v + 0.5f); }

// Write the 16-byte quad of `lvl` and of `par` (both (lh, lw)) into
// out[(y * stride + x) * 32 ...] for texels (y < lh, x < lw).
void write_quads(const Level& lvl, const Level& par, bool wrap,
                 uint8_t* out, int64_t stride) {
    const int64_t lh = lvl.h, lw = lvl.w;
    for (int64_t y = 0; y < lh; ++y) {
        int64_t yn = wrap ? (y + 1) % lh : (y + 1 < lh ? y + 1 : lh - 1);
        for (int64_t x = 0; x < lw; ++x) {
            int64_t xn = wrap ? (x + 1) % lw : (x + 1 < lw ? x + 1 : lw - 1);
            uint8_t* row = out + (y * stride + x) * 32;
            const Level* srcs[2] = {&lvl, &par};
            for (int s = 0; s < 2; ++s) {
                const Level& L = *srcs[s];
                const float* c00 = L.at(y, x);
                const float* c10 = L.at(y, xn);
                const float* c01 = L.at(yn, x);
                const float* c11 = L.at(yn, xn);
                uint8_t* dst = row + s * 16;
                for (int c = 0; c < 4; ++c) dst[c] = to_u8(c00[c]);
                for (int c = 0; c < 4; ++c) dst[4 + c] = to_u8(c10[c]);
                for (int c = 0; c < 4; ++c) dst[8 + c] = to_u8(c01[c]);
                for (int c = 0; c < 4; ++c) dst[12 + c] = to_u8(c11[c]);
            }
        }
    }
}

}  // namespace

extern "C" {

// img: (h, w, 4) u8. out: (total, 32) u8, pre-zeroed, where total =
// sum over levels of (base >> l)^2 down to 1x1. Returns 0 on success.
int32_t voidin_pack_texture(const uint8_t* img, int64_t h, int64_t w,
                            int64_t base, uint8_t* out) {
    if (h <= 0 || w <= 0 || base <= 0) return 1;
    // level sizes allocated at base, base/2, ..., 1
    std::vector<int64_t> sizes;
    for (int64_t s = base;; s /= 2) {
        sizes.push_back(s);
        if (s == 1) break;
    }
    std::vector<int64_t> offsets(sizes.size());
    int64_t acc = 0;
    for (size_t i = 0; i < sizes.size(); ++i) {
        offsets[i] = acc;
        acc += sizes[i] * sizes[i];
    }

    // full level chain of the actual image
    std::vector<Level> levels;
    Level l0;
    l0.h = h;
    l0.w = w;
    l0.px.resize(h * w * 4);
    for (int64_t i = 0; i < h * w * 4; ++i) l0.px[i] = (float)img[i];
    levels.push_back(std::move(l0));
    // numpy chain stops once EITHER dimension reaches 1 (min(h, w) > 1);
    // the allocated tail below propagates the last level's first row.
    while (levels.back().h > 1 && levels.back().w > 1)
        levels.push_back(downsample2x2(levels.back()));

    for (size_t li = 0; li < sizes.size(); ++li) {
        int64_t s = sizes[li];
        uint8_t* block = out + offsets[li] * 32;
        if (li >= levels.size()) {
            // propagate the 1x1 tail: copy the previous level's first row
            const uint8_t* prev = out + offsets[li - 1] * 32;
            for (int64_t i = 0; i < s * s; ++i)
                std::memcpy(block + i * 32, prev, 32);
            continue;
        }
        const Level& lvl = levels[li];
        const Level& parent =
            levels[li + 1 < levels.size() ? li + 1 : levels.size() - 1];
        Level par_rs = upsample_to_child(parent, lvl.h, lvl.w);
        write_quads(lvl, par_rs, /*wrap=*/true, block, s);
    }
    return 0;
}

}  // extern "C"
