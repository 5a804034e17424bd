// FusedHash trilinear blend, forward (B4) and point gradient (B5), and the
// exact table gradient, for Hopper (sm_90a).
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
//
// The exact table gradient (fused_dtable_kernel) replaces no TPU kernel: the
// JAX package leaves it to XLA, and the port summed it level by level in
// plain PyTorch (16 index_add_ scatters of materialised (N, 8F) updates, a
// third of a hash-grid train step). Every (point, level) adds g[f] * w[c]
// into entry 8f + c of its cell's row of d (L, rows, 8F) f32. What bounds it
// on an H100 is not bytes (points, g and d once: about 0.4 GB, 0.12 ms at
// the hash cell's 2.36M points x 16 levels x 2 features) but atomics on the
// same row: training points come as rays of S depth-sorted samples, so a
// warp's 32 neighbouring samples fall into one cell, or a few neighbouring
// ones, at the coarse levels, and their atomics would serialise on one
// 64-byte row. The design:
//  * one thread per (point, level), levels on the grid's y axis, so that
//    blocks run about one level at a time and that level's slab of d (4 MB
//    at 2^16 rows of 16 f32) stays in L2 (the whole table, 64 MB, does not);
//    points and g are read coalesced along N;
//  * the row is the forward gather's, bit for bit: the cell from
//    floor(pts*scale + 0.5) rounded as above, clamped to [0, res - 1], then
//    the dense index or the uint32 hash & (T - 1); a row that differed would
//    put the gradient on another row than the one the forward read;
//  * runs of equal rows in neighbouring lanes are summed in the warp before
//    any atomic: lanes flag run heads with a ballot, a segmented shuffle scan
//    sums each run's 8 values of a feature (as many rounds as the warp's
//    longest run needs: none where every lane has its own row, five where a
//    warp shares one), and the run's last lane adds them with two float4
//    vector atomics (red.global.add.v4.f32). Rows are 8F floats, whole
//    float4s, and d's rows start on 16-byte boundaries, so no scalar path is
//    needed. A warp that shares one row issues 2F atomics instead of 64F;
//    one whose rows are all distinct issues them as a scatter of precomputed
//    rows would, without materialising the updates;
//  * rows outside a slab [row0, row0 + rows) add nothing (the table's
//    tensor-parallel slabs each take their own rows on their own device).
// The products are the plain version's (g * weight, weights as in B4); the
// sums run in another order: the scan's tree inside a run, then atomics in
// a varying order across runs, where index_add_ adds one term at a time.
// Worst case: the same row across many warps (a coarse level's hot cell)
// still serialises one atomic per warp-run there.

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

// per-level constants of the table gradient: scale, resolution, dense flag
struct DtLevels {
  float s[FE_MAX_LEVELS];
  int res[FE_MAX_LEVELS];
  unsigned dense;  // bit l set: level l indexes its cells densely
};

// cell of one coordinate, clamped to [0, res - 1], and its frac, rounded as
// frac_of (a float compare clamps exactly: cellf is a whole number and res
// is below 2^24)
__device__ __forceinline__ int cell_and_frac(float x, float scale, int res, float* frac) {
  const float scaled = __fadd_rn(__fmul_rn(x, scale), 0.5f);
  const float cellf = floorf(scaled);
  *frac = __fsub_rn(scaled, cellf);
  return (int)fminf(fmaxf(cellf, 0.f), (float)(res - 1));
}

__global__ void __launch_bounds__(FE_THREADS)
fused_dtable_kernel(const float* __restrict__ pts, const float* __restrict__ g, float* __restrict__ d,
                    unsigned n, int nf, DtLevels lv, unsigned tmask, int row0, int rows) {
  const unsigned full = 0xffffffffu;
  const int l = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const unsigned p = blockIdx.x * FE_THREADS + threadIdx.x;
  const bool valid = p < n;  // a ragged last warp: its idle lanes own no row and add nothing
  float fx = 0.f, fy = 0.f, fz = 0.f;
  int row = -1;  // local row in the slab, -1: none
  if (valid) {
    const float scale = lv.s[l];
    const int res = lv.res[l];
    const int cx = cell_and_frac(pts[p], scale, res, &fx);
    const int cy = cell_and_frac(pts[n + p], scale, res, &fy);
    const int cz = cell_and_frac(pts[2 * n + p], scale, res, &fz);
    const unsigned r = ((lv.dense >> l) & 1u)
                           ? (unsigned)(cx + cy * res + cz * res * res)
                           : ((unsigned)cx ^ ((unsigned)cy * 2654435761u) ^ ((unsigned)cz * 805459861u)) & tmask;
    const int local = (int)r - row0;
    if (local >= 0 && local < rows) row = local;
  }
  // runs of equal rows: a head differs from the lane before it; pos is the
  // lane's place in its run, the tail (the run's last lane) adds the run
  const int prev = __shfl_up_sync(full, row, 1);
  const unsigned heads = __ballot_sync(full, lane == 0 || prev != row);
  const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
  const int pos = lane - (31 - __clz(heads & (full >> (31 - lane))));
  const int longest = __reduce_max_sync(full, pos + 1);

  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy), gz = __fsub_rn(1.f, fz);
  float w[8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
    w[c] = __fmul_rn(__fmul_rn(axis_w(c, 1, fx, gx), axis_w(c, 2, fy, gy)), axis_w(c, 4, fz, gz));
  float* drow = d + ((size_t)l * rows + (row < 0 ? 0 : row)) * (8 * nf);
  for (int f = 0; f < nf; ++f) {
    const float gv = valid ? __ldcs(g + (unsigned)(l * nf + f) * n + p) : 0.f;
    float v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = __fmul_rn(gv, w[c]);
    // segmented inclusive scan: after the round of offset k, a lane holds
    // the sum of the up to 2k lanes of its run that end at it
    for (int off = 1; off < longest; off <<= 1) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float o = __shfl_up_sync(full, v[c], off);
        if (pos >= off) v[c] = __fadd_rn(v[c], o);
      }
    }
    if (tail && row >= 0) {
      atomicAdd((float4*)(drow + 8 * f), make_float4(v[0], v[1], v[2], v[3]));
      atomicAdd((float4*)(drow + 8 * f + 4), make_float4(v[4], v[5], v[6], v[7]));
    }
  }
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

// d (L, rows, 8F) f32, zeroed by the caller, += the exact table gradient of
// the slab [row0, row0 + rows) of a table of table_size rows. Refuses
// (cudaErrorInvalidValue) what 32-bit offsets cannot index:
// n * n_levels * n_features or n_levels * rows * 8 * n_features of 2^31 or
// more, a table_size that is not a power of two up to 2^31.
extern "C" int loner_fused_dtable(const float* pts, const float* g, float* d, long long n, int n_levels,
                                  int n_features, const float* scales, const int* res, const int* dense,
                                  long long table_size, long long row0, long long rows, void* stream) {
  const unsigned long long limit = 1ULL << 31;
  if (n_levels < 1 || n_levels > FE_MAX_LEVELS || n_features < 1 || n_features > 32 || n < 0 || rows < 0 ||
      row0 < 0 || table_size < 1 || (unsigned long long)table_size > limit || (table_size & (table_size - 1)) ||
      row0 + rows > table_size)
    return (int)cudaErrorInvalidValue;
  if ((unsigned long long)n * n_levels * n_features >= limit ||
      (unsigned long long)rows * 8 * n_features * n_levels >= limit)
    return (int)cudaErrorInvalidValue;
  DtLevels lv;
  lv.dense = 0;
  for (int l = 0; l < FE_MAX_LEVELS; ++l) {
    const bool used = l < n_levels;
    if (used && (res[l] < 1 || res[l] > (1 << 24))) return (int)cudaErrorInvalidValue;
    lv.s[l] = used ? scales[l] : 0.f;
    lv.res[l] = used ? res[l] : 1;
    if (used && dense[l]) lv.dense |= 1u << l;
  }
  if (n == 0 || rows == 0) return 0;
  const dim3 grid((unsigned int)((n + FE_THREADS - 1) / FE_THREADS), (unsigned int)n_levels);
  fused_dtable_kernel<<<grid, FE_THREADS, 0, (cudaStream_t)stream>>>(
      pts, g, d, (unsigned)n, n_features, lv, (unsigned)(table_size - 1), (int)row0, (int)rows);
  return (int)cudaGetLastError();
}
