// Native host data-loader kernels for LSHM-TPU.
//
// The reference's input pipeline decodes int8 visibilities through several Python/torch
// passes (per-channel scale multiply, zero-pad, unfold, copy, clamp, normalize;
// reference: src/lofar_tools.py:112-193).  When a TPU consumes hundreds of thousands of
// patches per second the host becomes the bottleneck, so this library fuses the whole
// decode into a single cache-friendly pass:
//
//   int8 visibilities x per-(freq,pol) scale -> channel-select -> zero-pad ->
//   overlapping 50%-stride patch extraction (baseline-major) -> clamp ->
//   running sum/sumsq for global z-normalization
//
// Exposed as plain C symbols consumed via ctypes (no pybind11 in this image).
//
// Built at first use by lshm_tpu_torch/native/__init__.py
// ($CXX or g++ -O3 -fPIC -shared -std=c++17 -Wall -fopenmp [-march=native]).

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// vis:    [nb, ntime, nfreq, npol, 2] int8, baseline-subset rows already gathered
// scales: [nb, nfreq, npol] float32
// pols:   [npols_sel] selected polarization indices (e.g. {0,3} for 4-channel mode)
// out:    [nb * px * py, patch, patch, 2*npols_sel] float32, baseline-major patches
// stats:  [2] running {sum, sumsq} over all output elements (for global z-norm)
//
// Returns 0 on success, -1 on bad arguments.
int decode_patchify(
    const int8_t* vis,
    const float* scales,
    int nb, int ntime, int nfreq, int npol,
    const int* pols, int npols_sel,
    int patch, float clamp_val,
    float* out, double* stats)
{
    if (nb <= 0 || patch <= 0 || npols_sel <= 0) return -1;
    const int stride = patch / 2;
    const int padT = std::max(ntime, patch);
    const int padF = std::max(nfreq, patch);
    const int px = (padT - patch) / stride + 1;
    const int py = (padF - patch) / stride + 1;
    const int C = 2 * npols_sel;
    const long ppb = (long)px * py;               // patches per baseline
    const long patch_elems = (long)patch * patch * C;

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int b = 0; b < nb; ++b) {
        const int8_t* visb = vis + (long)b * ntime * nfreq * npol * 2;
        const float* scaleb = scales + (long)b * nfreq * npol;
        for (int pi = 0; pi < px; ++pi) {
            for (int pj = 0; pj < py; ++pj) {
                float* dst = out + ((long)b * ppb + (long)pi * py + pj) * patch_elems;
                const int t0 = pi * stride;
                const int f0 = pj * stride;
                for (int t = 0; t < patch; ++t) {
                    const int tt = t0 + t;
                    float* row = dst + (long)t * patch * C;
                    if (tt >= ntime) {            // zero padding region (time)
                        std::memset(row, 0, sizeof(float) * patch * C);
                        continue;
                    }
                    const int8_t* vrow = visb + (long)tt * nfreq * npol * 2;
                    for (int f = 0; f < patch; ++f) {
                        const int ff = f0 + f;
                        float* px_out = row + (long)f * C;
                        if (ff >= nfreq) {        // zero padding region (freq)
                            for (int c = 0; c < C; ++c) px_out[c] = 0.0f;
                            continue;
                        }
                        const int8_t* v = vrow + (long)ff * npol * 2;
                        const float* s = scaleb + (long)ff * npol;
                        for (int k = 0; k < npols_sel; ++k) {
                            const int p = pols[k];
                            float re = (float)v[p * 2 + 0] * s[p];
                            float im = (float)v[p * 2 + 1] * s[p];
                            px_out[2 * k + 0] = std::min(std::max(re, -clamp_val), clamp_val);
                            px_out[2 * k + 1] = std::min(std::max(im, -clamp_val), clamp_val);
                        }
                    }
                }
            }
        }
    }
    // stats in a separate contiguous pass: vectorizes cleanly, unlike a loop-carried
    // double accumulation inside the decode loop
    const long total = (long)nb * ppb * patch_elems;
    double sum = 0.0, sumsq = 0.0;
#ifdef _OPENMP
#pragma omp parallel for reduction(+ : sum, sumsq)
#endif
    for (long i = 0; i < total; ++i) {
        const double v = (double)out[i];
        sum += v;
        sumsq += v * v;
    }
    stats[0] = sum;
    stats[1] = sumsq;
    return 0;
}

// In-place global z-normalization given precomputed stats: x = (x - mean) / std.
void normalize_inplace(float* data, long n, double sum, double sumsq)
{
    const double mean = sum / (double)n;
    double var = sumsq / (double)n - mean * mean;
    const float std_inv = var > 0.0 ? (float)(1.0 / __builtin_sqrt(var)) : 1.0f;
    const float m = (float)mean;
    for (long i = 0; i < n; ++i) data[i] = (data[i] - m) * std_inv;
}

// Patch-grid helper so Python and C++ can never disagree on output geometry.
void patch_grid(int ntime, int nfreq, int patch, int* px, int* py)
{
    const int stride = patch / 2;
    const int padT = std::max(ntime, patch);
    const int padF = std::max(nfreq, patch);
    *px = (padT - patch) / stride + 1;
    *py = (padF - patch) / stride + 1;
}

}  // extern "C"
