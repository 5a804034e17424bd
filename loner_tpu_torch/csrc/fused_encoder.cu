// FusedHash trilinear blend, forward (B4) and point gradient (B5), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels loner_tpu/ops/fused_encoder.py::_fwd_kernel
// and ::_dpts_kernel. Layouts are the JAX package's: points (3, N) f32 in
// [0, 1], gathered corner rows v_t (L, 8F, N) bf16, feature-major
// [f0c0..f0c7, f1c0..f1c7, ...] with corner bits bit0 = x, bit1 = y,
// bit2 = z; features and their gradient g (L*F, N) f32; dpts (3, N) f32.
//
// What bounds them on an H100: bytes. Per point and level the forward reads
// 16F bytes of corner rows and writes 4F bytes; the backward reads the rows
// and 4F bytes of g. Both do a few tens of operations per byte at most, far
// below the card's ratio, so the design is about coalescing: the point axis
// is minor in every array, so a warp's 32 neighbouring points read and write
// 32 neighbouring values of each row.
//
//  * B4: one thread per (level, point), levels on the grid's y axis. It
//    forms the 8 corner weights once and writes F outputs.
//  * B5: one thread per point. It walks the levels in order and keeps the
//    point's gradient in registers, so the sum over levels needs no atomics
//    and no second pass (the TPU kernel carries it across its sequential
//    grid instead).
//
// Arithmetic uses the round-to-nearest intrinsics (no FMA contraction), in
// the JAX package's order: scaled = pts*scale then + 0.5, rounded separately
// (one FMA would move frac by up to an ulp of scaled, 1/32 at a scale of
// 2^19, and can flip the cell at a border); the 8 corners of a feature are
// summed first, then the levels. bf16 -> f32 is exact.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define FE_MAX_LEVELS 32
#define FE_THREADS 256

struct FeScales {
  float s[FE_MAX_LEVELS];
};

// frac = scaled - floor(scaled), scaled = x*scale + 0.5 rounded separately
__device__ __forceinline__ float frac_of(float x, float scale) {
  const float scaled = __fadd_rn(__fmul_rn(x, scale), 0.5f);
  return __fsub_rn(scaled, floorf(scaled));
}

// axis weights of corner c: bit set -> f, else 1 - f
__device__ __forceinline__ float axis_w(int c, int bit, float f, float one_minus_f) {
  return (c & bit) ? f : one_minus_f;
}

__global__ void fused_fwd_kernel(const float* __restrict__ pts, const __nv_bfloat16* __restrict__ v,
                                 float* __restrict__ out, long long n, int nf, FeScales sc) {
  const int l = blockIdx.y;
  const float scale = sc.s[l];
  const int rw = 8 * nf;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (long long)gridDim.x * blockDim.x) {
    const float fx = frac_of(pts[p], scale);
    const float fy = frac_of(pts[n + p], scale);
    const float fz = frac_of(pts[2 * n + p], scale);
    const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy), gz = __fsub_rn(1.f, fz);
    float w[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      w[c] = __fmul_rn(__fmul_rn(axis_w(c, 1, fx, gx), axis_w(c, 2, fy, gy)), axis_w(c, 4, fz, gz));
    const __nv_bfloat16* vl = v + (size_t)l * rw * n + p;
    float* o = out + (size_t)l * nf * n + p;
    for (int f = 0; f < nf; ++f) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(vl[(size_t)(8 * f + c) * n]), w[c]));
      o[(size_t)f * n] = acc;
    }
  }
}

__global__ void fused_dpts_kernel(const float* __restrict__ pts, const __nv_bfloat16* __restrict__ v,
                                  const float* __restrict__ g, float* __restrict__ dpts, long long n,
                                  int n_levels, int nf, FeScales sc) {
  const int rw = 8 * nf;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (long long)gridDim.x * blockDim.x) {
    const float x = pts[p], y = pts[n + p], z = pts[2 * n + p];
    float d[3] = {0.f, 0.f, 0.f};
    for (int l = 0; l < n_levels; ++l) {
      const float scale = sc.s[l];
      const float fx = frac_of(x, scale), fy = frac_of(y, scale), fz = frac_of(z, scale);
      const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy), gz = __fsub_rn(1.f, fz);
      // pc_c = sum_f v[8f + c] * g[f], summed from f = 0 up
      float pc[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) pc[c] = 0.f;
      const __nv_bfloat16* vl = v + (size_t)l * rw * n + p;
      const float* gl = g + (size_t)l * nf * n + p;
      for (int f = 0; f < nf; ++f) {
        const float gv = gl[(size_t)f * n];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          pc[c] = __fadd_rn(pc[c], __fmul_rn(__bfloat162float(vl[(size_t)(8 * f + c) * n]), gv));
      }
      // d_x = sum_c s_x(c) * w_y(c) * w_z(c) * pc_c, likewise y and z
      float dx = 0.f, dy = 0.f, dz = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float wx = axis_w(c, 1, fx, gx), wy = axis_w(c, 2, fy, gy), wz = axis_w(c, 4, fz, gz);
        const float sx = (c & 1) ? 1.f : -1.f, sy = (c & 2) ? 1.f : -1.f, sz = (c & 4) ? 1.f : -1.f;
        dx = __fadd_rn(dx, __fmul_rn(__fmul_rn(__fmul_rn(sx, wy), wz), pc[c]));
        dy = __fadd_rn(dy, __fmul_rn(__fmul_rn(__fmul_rn(sy, wx), wz), pc[c]));
        dz = __fadd_rn(dz, __fmul_rn(__fmul_rn(__fmul_rn(sz, wx), wy), pc[c]));
      }
      d[0] = __fadd_rn(d[0], __fmul_rn(dx, scale));
      d[1] = __fadd_rn(d[1], __fmul_rn(dy, scale));
      d[2] = __fadd_rn(d[2], __fmul_rn(dz, scale));
    }
    dpts[p] = d[0];
    dpts[n + p] = d[1];
    dpts[2 * n + p] = d[2];
  }
}

static int scales_from(const float* scales, int n_levels, int nf, FeScales* sc) {
  if (n_levels < 1 || n_levels > FE_MAX_LEVELS || nf < 1 || nf > 32) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < FE_MAX_LEVELS; ++l) sc->s[l] = l < n_levels ? scales[l] : 0.f;
  return 0;
}

static unsigned int blocks_for(long long n) {
  const long long want = (n + FE_THREADS - 1) / FE_THREADS;
  const long long cap = 1LL << 30;  // the grid-stride loops cover the rest
  return (unsigned int)(want < cap ? want : cap);
}

extern "C" int loner_fused_fwd(const float* pts, const void* v, float* out, long long n, int n_levels,
                               int n_features, const float* scales, void* stream) {
  FeScales sc;
  int rc = scales_from(scales, n_levels, n_features, &sc);
  if (rc) return rc;
  if (n <= 0) return 0;
  const dim3 grid(blocks_for(n), (unsigned int)n_levels);
  fused_fwd_kernel<<<grid, FE_THREADS, 0, (cudaStream_t)stream>>>(
      pts, (const __nv_bfloat16*)v, out, n, n_features, sc);
  return (int)cudaGetLastError();
}

extern "C" int loner_fused_dpts(const float* pts, const void* v, const float* g, float* dpts, long long n,
                                int n_levels, int n_features, const float* scales, void* stream) {
  FeScales sc;
  int rc = scales_from(scales, n_levels, n_features, &sc);
  if (rc) return rc;
  if (n <= 0) return 0;
  fused_dpts_kernel<<<blocks_for(n), FE_THREADS, 0, (cudaStream_t)stream>>>(
      pts, (const __nv_bfloat16*)v, g, dpts, n, n_levels, n_features, sc);
  return (int)cudaGetLastError();
}
