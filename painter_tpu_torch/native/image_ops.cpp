// Native host-side image ops for the training data pipeline.
//
// Role: the per-sample CPU work of the sample workers that feed the GPU
// (the reference leans on torchvision's C kernels for the same stage;
// the numpy versions in painter_tpu_torch/data/transforms.py are
// multi-pass, and the seccrop resize there is a dense gemm over the whole
// crop axis). These single-pass C kernels replace them; parallelism
// across samples stays with the worker pool. The JAX package builds the
// same source (painter_tpu/native/image_ops.cpp).
//
// All functions are plain C ABI for ctypes. Images are contiguous
// float32 HWC in [0, 1] unless stated. Formulas mirror
// painter_tpu_torch/data/transforms.py (torchvision semantics)
// bit-for-bit in structure; tests pin parity against the numpy path.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

static inline float clamp01(float v) {
    return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

static inline float gray(const float* p) {
    return 0.2989f * p[0] + 0.587f * p[1] + 0.114f * p[2];
}

// op ids: 0 brightness, 1 contrast, 2 saturation, 3 hue
// factors: per slot in `order`; NaN = skip that slot.
void color_jitter(float* img, int64_t h, int64_t w, const int32_t* order,
                  const float* factors) {
    const int64_t n = h * w;
    for (int slot = 0; slot < 4; ++slot) {
        const float f = factors[slot];
        if (std::isnan(f)) continue;
        switch (order[slot]) {
        case 0: {  // brightness: clip(img * f)
            for (int64_t i = 0; i < 3 * n; ++i)
                img[i] = clamp01(img[i] * f);
            break;
        }
        case 1: {  // contrast: clip(f*img + (1-f)*mean(gray(img)))
            double acc = 0.0;
            for (int64_t i = 0; i < n; ++i) acc += gray(img + 3 * i);
            // numpy float32 .mean() accumulates in pairwise fp32; the
            // double accumulator here is at least as accurate.
            const float m = (float)(acc / (double)n) * (1.0f - f);
            for (int64_t i = 0; i < 3 * n; ++i)
                img[i] = clamp01(f * img[i] + m);
            break;
        }
        case 2: {  // saturation: clip(f*img + (1-f)*gray(pixel))
            const float g1 = 1.0f - f;
            for (int64_t i = 0; i < n; ++i) {
                float* p = img + 3 * i;
                const float gr = g1 * gray(p);
                p[0] = clamp01(f * p[0] + gr);
                p[1] = clamp01(f * p[1] + gr);
                p[2] = clamp01(f * p[2] + gr);
            }
            break;
        }
        case 3: {  // hue shift by f in [-0.5, 0.5] via HSV
            for (int64_t i = 0; i < n; ++i) {
                float* p = img + 3 * i;
                const float r = p[0], g = p[1], b = p[2];
                const float maxc = fmaxf(r, fmaxf(g, b));
                const float minc = fminf(r, fminf(g, b));
                const float v = maxc;
                const float delta = maxc - minc;
                const float s =
                    maxc > 0.0f ? delta / fmaxf(maxc, 1e-12f) : 0.0f;
                const float dz = fmaxf(delta, 1e-12f);
                float hh;
                if (maxc == r)
                    hh = (maxc - b) / dz - (maxc - g) / dz;
                else if (maxc == g)
                    hh = 2.0f + (maxc - r) / dz - (maxc - b) / dz;
                else
                    hh = 4.0f + (maxc - g) / dz - (maxc - r) / dz;
                if (delta == 0.0f) hh = 0.0f;
                hh = hh / 6.0f;
                hh = hh - floorf(hh);
                hh = hh + f;
                hh = hh - floorf(hh);
                const float vs = v * s;
                const float h6 = hh * 6.0f;
                for (int ch = 0; ch < 3; ++ch) {
                    const float nn = ch == 0 ? 5.0f : (ch == 1 ? 3.0f : 1.0f);
                    float k = nn + h6;
                    k = k - 6.0f * floorf(k / 6.0f);
                    float t = fminf(k, 4.0f - k);
                    t = t < 0.0f ? 0.0f : (t > 1.0f ? 1.0f : t);
                    p[ch] = clamp01(v - vs * t);
                }
            }
            break;
        }
        }
    }
}

// uint8 HWC -> ImageNet-normalized float32 HWC in one pass.
void normalize_u8(const uint8_t* src, float* dst, int64_t h, int64_t w,
                  const float* mean, const float* stdv) {
    const int64_t n = h * w;
    const float inv255 = 1.0f / 255.0f;
    float lut[3][256];
    for (int c = 0; c < 3; ++c) {
        const float inv_s = 1.0f / stdv[c];
        for (int v = 0; v < 256; ++v)
            lut[c][v] = ((float)v * inv255 - mean[c]) * inv_s;
    }
    for (int64_t i = 0; i < n; ++i) {
        dst[3 * i + 0] = lut[0][src[3 * i + 0]];
        dst[3 * i + 1] = lut[1][src[3 * i + 1]];
        dst[3 * i + 2] = lut[2][src[3 * i + 2]];
    }
}

// float32 HWC -> normalized float32 HWC (input already in [0,1]).
void normalize_f32(const float* src, float* dst, int64_t h, int64_t w,
                   const float* mean, const float* stdv) {
    const int64_t n = h * w;
    float im[3], iv[3];
    for (int c = 0; c < 3; ++c) { im[c] = mean[c]; iv[c] = 1.0f / stdv[c]; }
    for (int64_t i = 0; i < n; ++i)
        for (int c = 0; c < 3; ++c)
            dst[3 * i + c] = (src[3 * i + c] - im[c]) * iv[c];
}

// Separable banded resize (torch F.interpolate semantics: the caller
// provides, per output index, `taps` clipped source indices + weights —
// exactly the nonzeros of ops/resample.resize_weights' dense matrix).
// src (in_h, in_w, c) -> dst (out_h, out_w, c), fp32 accumulation.
void resize_hwc(const float* src, int64_t in_h, int64_t in_w, int64_t c,
                float* dst, int64_t out_h, int64_t out_w,
                const int32_t* idx_h, const float* w_h, int32_t taps_h,
                const int32_t* idx_w, const float* w_w, int32_t taps_w) {
    // pass 1: rows (vertical), src -> tmp (out_h, in_w, c)
    float* tmp = (float*)malloc(sizeof(float) * out_h * in_w * c);
    const int64_t row = in_w * c;
    for (int64_t y = 0; y < out_h; ++y) {
        float* trow = tmp + y * row;
        memset(trow, 0, sizeof(float) * row);
        for (int32_t k = 0; k < taps_h; ++k) {
            const float wk = w_h[y * taps_h + k];
            if (wk == 0.0f) continue;
            const float* srow = src + (int64_t)idx_h[y * taps_h + k] * row;
            for (int64_t j = 0; j < row; ++j) trow[j] += wk * srow[j];
        }
    }
    // pass 2: columns (horizontal), tmp -> dst
    for (int64_t y = 0; y < out_h; ++y) {
        const float* trow = tmp + y * row;
        float* drow = dst + y * out_w * c;
        for (int64_t x = 0; x < out_w; ++x) {
            float acc[16];  // c <= 16 fast path
            if (c <= 16) {
                for (int64_t ch = 0; ch < c; ++ch) acc[ch] = 0.0f;
                for (int32_t k = 0; k < taps_w; ++k) {
                    const float wk = w_w[x * taps_w + k];
                    const float* sp =
                        trow + (int64_t)idx_w[x * taps_w + k] * c;
                    for (int64_t ch = 0; ch < c; ++ch)
                        acc[ch] += wk * sp[ch];
                }
                for (int64_t ch = 0; ch < c; ++ch)
                    drow[x * c + ch] = acc[ch];
            } else {
                float* dp = drow + x * c;
                for (int64_t ch = 0; ch < c; ++ch) dp[ch] = 0.0f;
                for (int32_t k = 0; k < taps_w; ++k) {
                    const float wk = w_w[x * taps_w + k];
                    const float* sp =
                        trow + (int64_t)idx_w[x * taps_w + k] * c;
                    for (int64_t ch = 0; ch < c; ++ch)
                        dp[ch] += wk * sp[ch];
                }
            }
        }
    }
    free(tmp);
}

// nearest gather along both axes (torch legacy 'nearest')
void resize_nearest_hwc(const float* src, int64_t in_h, int64_t in_w,
                        int64_t c, float* dst, int64_t out_h,
                        int64_t out_w, const int32_t* idx_h,
                        const int32_t* idx_w) {
    for (int64_t y = 0; y < out_h; ++y) {
        const float* srow = src + (int64_t)idx_h[y] * in_w * c;
        float* drow = dst + y * out_w * c;
        for (int64_t x = 0; x < out_w; ++x)
            memcpy(drow + x * c, srow + (int64_t)idx_w[x] * c,
                   sizeof(float) * c);
    }
}

}  // extern "C"
