// Native data-generation kernels for the rotating-image pipeline.
//
// The host-side hot path of this framework is dataset synthesis/
// augmentation: rotating every base image through T angles (the reference
// does this with scipy.ndimage.rotate per frame, data/mnist.py:149-160 -
// its only CPU-heavy loop). This C++ implementation rotates with bilinear
// resampling about the exact scipy center convention ((dim-1)/2,
// reshape=False, constant 0 fill) and batches whole sequence datasets in
// one call.
//
// The PyTorch/CUDA port's own copy of the source: built on first use with
// g++ -O3 (vae_gp_ode_tpu_torch/native/build.py) and bound with ctypes.

#include <cmath>
#include <cstdint>
#include <algorithm>

extern "C" {

// Rotate one (h, w) float32 image by angle_deg counterclockwise about the
// center, bilinear interpolation, zero fill (scipy.ndimage.rotate
// reshape=False, order=1 semantics).
void rotate_bilinear(const float* src, float* dst, int h, int w,
                     float angle_deg) {
    // scipy.ndimage.rotate's positive-angle direction (array coords);
    // double-precision mapping with an epsilon boundary clamp so exact
    // 90/180/270-degree rotations keep their border pixels (float trig
    // noise would otherwise push boundary coordinates out of range)
    const double rad = -angle_deg * 3.14159265358979323846 / 180.0;
    const double c = std::cos(rad), s = std::sin(rad);
    const double cy = 0.5 * (h - 1), cx = 0.5 * (w - 1);
    const double eps = 1e-6;
    for (int y = 0; y < h; ++y) {
        const double dy = y - cy;
        for (int x = 0; x < w; ++x) {
            const double dx = x - cx;
            // inverse-rotate the output coordinate into the source frame
            double sy = c * dy - s * dx + cy;
            double sx = s * dy + c * dx + cx;
            float v = 0.0f;
            if (sy >= -eps && sy <= h - 1 + eps && sx >= -eps
                && sx <= w - 1 + eps) {
                sy = std::min(std::max(sy, 0.0), (double)(h - 1));
                sx = std::min(std::max(sx, 0.0), (double)(w - 1));
                const int y0 = (int)sy, x0 = (int)sx;
                const int y1 = std::min(y0 + 1, h - 1);
                const int x1 = std::min(x0 + 1, w - 1);
                const float fy = (float)(sy - y0), fx = (float)(sx - x0);
                const float v00 = src[y0 * w + x0];
                const float v01 = src[y0 * w + x1];
                const float v10 = src[y1 * w + x0];
                const float v11 = src[y1 * w + x1];
                v = (1 - fy) * ((1 - fx) * v00 + fx * v01)
                    + fy * ((1 - fx) * v10 + fx * v11);
            }
            dst[y * w + x] = v;
        }
    }
}

// Batch: for each of n base images (h, w), produce T frames rotated by
// t * (360 / T) + offset[i] degrees; output (n, T, h, w), clipped to
// [0, 1].
void make_rot_sequences(const float* bases, float* out, int n, int T,
                        int h, int w, const float* offsets) {
    const int hw = h * w;
    const float step = 360.0f / (float)T;
    for (int i = 0; i < n; ++i) {
        const float* base = bases + (int64_t)i * hw;
        for (int t = 0; t < T; ++t) {
            float* dst = out + ((int64_t)i * T + t) * hw;
            rotate_bilinear(base, dst, h, w, step * t + offsets[i]);
            for (int p = 0; p < hw; ++p)
                dst[p] = std::min(1.0f, std::max(0.0f, dst[p]));
        }
    }
}

// Batch: rotate each of n images by its own angle (used for the
// VAE-pretraining frame datasets, arbitrary angle lists).
void rotate_batch(const float* srcs, float* out, int n, int h, int w,
                  const float* angles) {
    const int hw = h * w;
    for (int i = 0; i < n; ++i) {
        rotate_bilinear(srcs + (int64_t)i * hw, out + (int64_t)i * hw,
                        h, w, angles[i]);
        for (int p = 0; p < hw; ++p) {
            float* v = out + (int64_t)i * hw + p;
            *v = std::min(1.0f, std::max(0.0f, *v));
        }
    }
}

}  // extern "C"
