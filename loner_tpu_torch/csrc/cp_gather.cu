// CP feature-line forward by direct lookups, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/bench_lane_gather.py
// `_gather_fwd_kernel` (P5), which computes the forward of B1
// (loner_tpu/ops/cp_kernel.py::_fwd_kernel) by lane gathers instead of a
// two-hot matrix product. Layouts are the JAX package's: points (3, N) f32 in
// [0, 1], lines (3L, F, 128) f32 level-major [x, y, z] with rows padded to
// 128, features (L*F, N) f32. Per level and axis: pix = clip(x, 0, 1)*(res-1),
// i0 = clip(floor(pix), 0, res-2), fr = pix - i0, lerp = v0*(1-fr) + v1*fr;
// the level's features are lerp_x * lerp_y * lerp_z, in that order.
//
// What bounds it on an H100: bytes, as for B1 (12 B of points in and 4*L*F B
// of features out per point: 632 MB at the flagship's 2.36M points,
// 0.19 ms at 3.35 TB/s). The design differs from B1's in the table: every
// block copies the whole padded lines, in their own (3L, F, 128) layout
// (98 KB at L = 4, F = 16), into dynamic shared memory with 16-byte copies,
// where B1 copies only the active rows, transposed to an odd row stride.
// One thread per point walks the levels and features and writes
// out[(l*F + f)*N + p], so that a warp's stores are 32 neighbouring floats.
// The grid is a few blocks per SM walking the points, so the table is
// copied a few hundred times, not once per 256 points.
//
// Arithmetic uses the round-to-nearest intrinsics (no FMA contraction), in
// the plain version's order, so the result is bit-identical to it.

#include <cuda_runtime.h>

#define CG_PAD_R 128
#define CG_MAX_LEVELS 8
#define CG_THREADS 256

struct CgLevels {
  int res[CG_MAX_LEVELS];
};

__device__ __forceinline__ void cg_axis_iwf(float x, int res, int& i0, float& fr) {
  const float xc = x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
  const float pix = __fmul_rn(xc, (float)(res - 1));
  int i = (int)floorf(pix);
  i = i < 0 ? 0 : (i > res - 2 ? res - 2 : i);
  i0 = i;
  fr = __fsub_rn(pix, (float)i);
}

__device__ __forceinline__ float cg_lerp(const float* line, int i0, float fr) {
  return __fadd_rn(__fmul_rn(line[i0], __fsub_rn(1.f, fr)), __fmul_rn(line[i0 + 1], fr));
}

__global__ void cp_gather_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ lines,
                                     float* __restrict__ out, long long n, int n_levels, int nf,
                                     CgLevels lv) {
  extern __shared__ float4 smem4[];
  const float* tab = reinterpret_cast<const float*>(smem4);
  const int n4 = 3 * n_levels * nf * CG_PAD_R / 4;
  const float4* src4 = reinterpret_cast<const float4*>(lines);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) smem4[i] = src4[i];
  __syncthreads();

  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (long long)gridDim.x * blockDim.x) {
    const float xyz[3] = {pts[p], pts[n + p], pts[2 * n + p]};
    for (int l = 0; l < n_levels; ++l) {
      int i0[3];
      float fr[3];
      for (int a = 0; a < 3; ++a) cg_axis_iwf(xyz[a], lv.res[l], i0[a], fr[a]);
      const float* lx = tab + (size_t)(3 * l) * nf * CG_PAD_R;
      const float* ly = lx + (size_t)nf * CG_PAD_R;
      const float* lz = ly + (size_t)nf * CG_PAD_R;
      float* dst = out + (size_t)l * nf * n + p;
      for (int f = 0; f < nf; ++f) {
        const float fx = cg_lerp(lx + f * CG_PAD_R, i0[0], fr[0]);
        const float fy = cg_lerp(ly + f * CG_PAD_R, i0[1], fr[1]);
        const float fz = cg_lerp(lz + f * CG_PAD_R, i0[2], fr[2]);
        dst[(size_t)f * n] = __fmul_rn(__fmul_rn(fx, fy), fz);
      }
    }
  }
}

extern "C" int loner_cp_gather_fwd(const float* pts, const float* lines, float* out, long long n,
                                   int n_levels, int n_features, const int* res, void* stream) {
  if (n_levels < 1 || n_levels > CG_MAX_LEVELS || n_features < 1) return (int)cudaErrorInvalidValue;
  CgLevels lv;
  for (int l = 0; l < CG_MAX_LEVELS; ++l) {
    lv.res[l] = l < n_levels ? res[l] : 0;
    if (l < n_levels && (res[l] < 2 || res[l] > CG_PAD_R)) return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  const size_t smem = (size_t)3 * n_levels * n_features * CG_PAD_R * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(cp_gather_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cp_gather_fwd_kernel, CG_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = (n + CG_THREADS - 1) / CG_THREADS;
  const long long cap = (long long)sms * per_sm;
  const int blocks = (int)(want < cap ? want : cap);
  cp_gather_fwd_kernel<<<blocks, CG_THREADS, smem, (cudaStream_t)stream>>>(pts, lines, out, n, n_levels,
                                                                           n_features, lv);
  return (int)cudaGetLastError();
}
