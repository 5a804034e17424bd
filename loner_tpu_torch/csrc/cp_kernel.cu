// CP feature-line encode, forward (B1) and backward (B2), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels loner_tpu/ops/cp_kernel.py::_fwd_kernel and
// ::_bwd_kernel. Layouts are the JAX package's: points (3, N) f32 in [0, 1],
// lines (3L, F, 128) f32 level-major [x, y, z], features (L*F, N) f32.
//
// What bounds them on an H100: bytes. The forward reads 12 B and writes
// 4*L*F B per point (L*F = 64 at the flagship: 604 MB at 2.36M points, about
// 0.19 ms at 3.35 TB/s); the backward reads the same (L*F, N) gradient and
// 12 B of points and writes 12 B per point (about 0.197 ms). The forward
// copies the active line rows (res_l per line, not the 128-row padding) into
// shared memory once per block and walks the point axis one thread a point,
// so the (L*F, N) rows are written coalesced.
//
// The backward. The TPU kernel builds a two-hot matrix W and does
// dlines = g' @ W^T on the MXU; here dlines is a scatter into a small, hot
// table: 2 x 3 weighted adds per (point, level, feature), 151M items at the
// flagship, besides the per-point dpts sum over features. The bound is bytes:
// 0.197 ms for the 604 MB gradient, the points and dpts.
//
// The first design gave each thread a point and summed every (level, axis,
// feature)'s adds across the warp with a segmented shuffle reduction before
// one shared-memory atomic per segment. A warp of 32 ray-ordered samples
// holds only 1.0-2.2 cells of a line, so each reduction ran its full 5
// rounds: 1,920 shuffles per 32 points, issue-bound at 1.95 ms on an H100,
// 1.89 ms of it on the dlines path.
//
// This design uses the runs instead: consecutive samples of a ray stay in
// one cell of a line for 25-400 points. A block takes a contiguous range of
// tiles of `runs * 16` points. Per tile it computes each (point, level)'s
// three cells (packed into one int) and fractions once, into 16-byte records
// in shared memory; the next tile's points arrive meanwhile by cp.async.
// Each thread owns one feature lane f and one run of 16 consecutive points
// and walks the run level by level. For each axis it keeps the current
// cell's line values and its lo/hi sums in registers and adds into them
// while the cell stays the same; only when the cell changes, and at the
// run's end, does it add the two sums into the block's shared-memory dlines
// (rows at an odd stride). No shuffle is on the dlines path. The card has no
// shared-memory float add: each of those adds is a compare-and-swap loop, so
// they are kept few. A new cell's line values are read from the lines in
// global memory (L1), since a change is rare. The 16 gradients of a run come
// from global memory as float4s straight into registers, and the next
// (level, feature)'s are loaded into the registers of this one as they are
// consumed (after item 7 and after item 15), so the loads overlap the work;
// staging them in shared memory would need 32 KB more a block and halve the
// blocks an SM holds, and registers, not shared memory, bound the occupancy
// (128 a thread, two blocks of 256 threads an SM).
//
// dpts is a per-point sum over features: a thread keeps its 16 points'
// three sums over all levels in registers. With F = 16 (LANES16) a run's 16
// lanes are one half of a warp, and a reduce-scatter of xor shuffles (4
// rounds) leaves lane j with point j's sums; otherwise the sums go through
// shared memory at a row pitch of 3*ft+1 floats and one pass a tile adds
// each point's entries. The block's dlines are added to global memory once,
// one atomic per non-zero entry; a contiguous range of tiles touches few
// cells.
//
// Points in a random order are the design's worst case, still correct:
// nearly every item changes cell and costs 6 compare-and-swap adds and 6 line
// loads. The launch arithmetic (runs, threads, shared memory; refusing what
// does not fit) is ops/cp_kernel.py::cp_bwd_plan's; the C entry checks it.
//
// The forward uses the round-to-nearest intrinsics (no FMA contraction) in
// the plain PyTorch version's order, so it is bit-identical to it. The
// backward uses fused multiply-adds and sums in its own order; `mm_bf16`
// rounds g * feat_b * feat_c and the two hat weights to bf16 before the
// dlines product, as the TPU kernel does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#define CP_PAD_R 128
#define CP_MAX_LEVELS 8
#define CP_THREADS 256
#define CP_BWD_MAX_THREADS 256
#define CP_BWD_RUN 16  // consecutive points a thread walks
#define CP_SMEM_BYTES 232448

struct CpLevels {
  int res[CP_MAX_LEVELS];
  int base[CP_MAX_LEVELS];  // first shared-memory row of level l's x line
};

// Shared-memory table: for level l and axis a, rows
// [base_l + a*res_l, base_l + (a+1)*res_l), each of nf floats at a row
// stride of rs = nf | 1 floats.
__device__ __forceinline__ void load_lines(float* tab, const float* __restrict__ lines,
                                           int n_levels, int nf, int rs, const CpLevels& lv) {
  for (int l = 0; l < n_levels; ++l) {
    const int res = lv.res[l];
    for (int a = 0; a < 3; ++a) {
      const float* src = lines + (size_t)(3 * l + a) * nf * CP_PAD_R;
      float* dst = tab + (size_t)(lv.base[l] + a * res) * rs;
      for (int idx = threadIdx.x; idx < nf * res; idx += blockDim.x) {
        const int f = idx / res;
        const int i = idx - f * res;
        dst[i * rs + f] = src[f * CP_PAD_R + i];
      }
    }
  }
}

// x -> (i0, frac) exactly as the plain version: clip to [0, 1] (NaN passes
// through, as jnp.clip lets it), scale by res-1, floor, clamp to [0, res-2].
__device__ __forceinline__ void axis_iwf(float x, int res, int& i0, float& fr) {
  const float xc = x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
  const float pix = __fmul_rn(xc, (float)(res - 1));
  int i = (int)floorf(pix);  // NaN converts to 0
  i = i < 0 ? 0 : (i > res - 2 ? res - 2 : i);
  i0 = i;
  fr = __fsub_rn(pix, (float)i);
}

__device__ __forceinline__ float lerp_rn(float v0, float v1, float fr) {
  return __fadd_rn(__fmul_rn(v0, __fsub_rn(1.f, fr)), __fmul_rn(v1, fr));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void cp_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ lines,
                              float* __restrict__ out, long long n, int n_levels, int nf,
                              CpLevels lv) {
  extern __shared__ float tab[];
  const int rs = nf | 1;
  load_lines(tab, lines, n_levels, nf, rs, lv);
  __syncthreads();

  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (long long)gridDim.x * blockDim.x) {
    const float xyz[3] = {pts[p], pts[n + p], pts[2 * n + p]};
    for (int l = 0; l < n_levels; ++l) {
      const int res = lv.res[l];
      const float* row[3];
      float fr[3];
      for (int a = 0; a < 3; ++a) {
        int i0;
        axis_iwf(xyz[a], res, i0, fr[a]);
        row[a] = tab + (size_t)(lv.base[l] + a * res + i0) * rs;
      }
      float* dst = out + (size_t)l * nf * n + p;
      for (int f = 0; f < nf; ++f) {
        const float fx = lerp_rn(row[0][f], row[0][rs + f], fr[0]);
        const float fy = lerp_rn(row[1][f], row[1][rs + f], fr[1]);
        const float fz = lerp_rn(row[2][f], row[2][rs + f], fr[2]);
        dst[(size_t)f * n] = __fmul_rn(__fmul_rn(fx, fy), fz);
      }
    }
  }
}

// f(std::integral_constant<int, K>) for K = 0 .. N-1, in order.
template <typename F, int... K>
__device__ __forceinline__ void static_for_impl(F&& f, std::integer_sequence<int, K...>) {
  (f(std::integral_constant<int, K>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// One round of a reduce-scatter over the lanes that differ in bit M: of the
// first S values, a lane keeps the half its bit selects (the upper half where
// it is set) and adds its partner's copy of that half to it.
template <int S, int M, int N>
__device__ __forceinline__ void reduce_half(float (&v)[N], int lane) {
  const bool upper = lane & M;
#pragma unroll
  for (int i = 0; i < S / 2; ++i) {
    const float send = upper ? v[i] : v[i + S / 2];
    const float keep = upper ? v[i + S / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// Half H of the R gradients of one (level, feature) row at points
// p0 .. p0+R-1 (R/2 values from p0 + H*R/2), zero past n; as float4s where
// the row is 16-byte aligned and the run is whole.
template <int R, int H>
__device__ __forceinline__ void load_half(float (&gr)[R], const float* __restrict__ row, long long p0,
                                          long long n, bool vec) {
  constexpr int B = H * (R / 2);
  if (vec && p0 + R <= n) {
    const float4* v = reinterpret_cast<const float4*>(row + p0 + B);
#pragma unroll
    for (int j = 0; j < R / 8; ++j) {
      const float4 x = __ldg(v + j);
      gr[B + 4 * j] = x.x;
      gr[B + 4 * j + 1] = x.y;
      gr[B + 4 * j + 2] = x.z;
      gr[B + 4 * j + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = B; k < B + R / 2; ++k) gr[k] = p0 + k < n ? __ldg(row + p0 + k) : 0.f;
  }
}

// Shared memory: the block's dlines (table_floats, rows at stride nf | 1,
// padded to 16 bytes); a scratch area that holds the tile's cells while the
// levels are walked ([L][tile] records of the key and the three fractions,
// one 16-byte load an item) and, unless LANES16, the threads' dpts partial
// sums after ([tile][3*ft + 1]); the next tile's points, staged by cp.async
// ([3][tile]); the tile's live masks (bit a: 0 < x_a < 1).
//
// LANES16 (F = 16, the flagship's): a run's 16 feature lanes are one half of
// a warp, and its 16 points' dpts sums are reduced over them by a
// reduce-scatter of xor shuffles (4 rounds; lane j ends with point j), with
// no shared memory and no barrier.
//
// A thread walks its units, (tile, level, feature) in that order, and loads
// the next unit's gradients into the registers of the current one as they
// are consumed: the first half after item R/2 - 1, the second after the
// last item, so the loads overlap the work.
template <bool BF16, bool LANES16>
__global__ void __launch_bounds__(CP_BWD_MAX_THREADS, 2)
cp_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ lines,
              const float* __restrict__ g, float* __restrict__ dlines, float* __restrict__ dpts,
              long long n, int n_levels, int nf, CpLevels lv, int table_floats, int ft, int runs,
              long long tiles_per_block, bool vec) {
  constexpr int R = CP_BWD_RUN;
  extern __shared__ float smem[];
  const int rs = nf | 1;
  const int tile = runs * R;
  const int rp = 3 * ft + 1;
  const int scratch = LANES16 || 4 * n_levels * tile > tile * rp ? 4 * n_levels * tile : tile * rp;
  float* acc = smem;
  float* part = smem + ((table_floats + 3) & ~3);
  int4* cells = reinterpret_cast<int4*>(part);
  float* stage = part + scratch;
  int* live = reinterpret_cast<int*>(stage + 3 * tile);
  for (int i = threadIdx.x; i < table_floats; i += blockDim.x) acc[i] = 0.f;

  const int fl = threadIdx.x % ft;  // feature lane: features fl, fl + ft, ...
  const int run = threadIdx.x / ft;
  const bool active = run < runs;
  const long long n_tiles = (n + tile - 1) / tile;
  const long long t_begin = blockIdx.x * tiles_per_block;
  const long long t_end = t_begin + tiles_per_block < n_tiles ? t_begin + tiles_per_block : n_tiles;

  auto stage_points = [&](long long t) {
    for (int i = threadIdx.x; i < 3 * tile; i += blockDim.x) {
      const int a = i / tile;
      const long long q = t * tile + (i - a * tile);
      if (q < n) __pipeline_memcpy_async(stage + i, pts + a * n + q, sizeof(float));
    }
    __pipeline_commit();
  };
  if (t_begin < t_end) stage_points(t_begin);
  float gr[R];
  if (active && t_begin < t_end) {
    const float* row = g + (size_t)fl * n;
    const long long p0 = t_begin * tile + (long long)run * R;
    load_half<R, 0>(gr, row, p0, n, vec);
    load_half<R, 1>(gr, row, p0, n, vec);
  }

  for (long long t = t_begin; t < t_end; ++t) {
    const long long t0 = t * tile;
    __pipeline_wait_prior(0);
    __syncthreads();  // the points are staged; the last tile's partial sums are read
    for (int p = threadIdx.x; p < tile; p += blockDim.x) {
      const bool in = t0 + p < n;
      const float xyz[3] = {in ? stage[p] : 0.5f, in ? stage[tile + p] : 0.5f, in ? stage[2 * tile + p] : 0.5f};
      int mask = 0;
      for (int a = 0; a < 3; ++a) mask |= (xyz[a] > 0.f && xyz[a] < 1.f) << a;
      live[p] = mask;
      for (int l = 0; l < n_levels; ++l) {
        int i0[3];
        float fr[3];
        for (int a = 0; a < 3; ++a) axis_iwf(xyz[a], lv.res[l], i0[a], fr[a]);
        cells[l * tile + p] = make_int4(i0[0] | i0[1] << 8 | i0[2] << 16, __float_as_int(fr[0]),
                                        __float_as_int(fr[1]), __float_as_int(fr[2]));
      }
    }
    __syncthreads();
    if (t + 1 < t_end) stage_points(t + 1);

    float dp[R][3];
#pragma unroll
    for (int k = 0; k < R; ++k) dp[k][0] = dp[k][1] = dp[k][2] = 0.f;
    if (active) {
      for (int l = 0; l < n_levels; ++l) {
        const int res = lv.res[l];
        const float scale = (float)(res - 1);
        const int4* cl = cells + l * tile + run * R;
        for (int f = fl; f < nf; f += ft) {
          // the next unit, whose gradients are loaded while this one runs
          long long t_n = t;
          int l_n = l, f_n = f + ft;
          if (f_n >= nf) {
            f_n = fl;
            if (++l_n == n_levels) {
              l_n = 0;
              ++t_n;
            }
          }
          const bool has_next = t_n < t_end;
          const float* row_n = g + ((size_t)l_n * nf + f_n) * n;
          const long long p0_n = t_n * tile + (long long)run * R;

          const float* src = lines + ((size_t)3 * l * nf + f) * CP_PAD_R;  // x line; + a*nf*128
          float* dst = acc + (size_t)lv.base[l] * rs + f;                  // x line; + a*res*rs
          int cell[3] = {-1, -1, -1};
          float v0[3] = {0.f, 0.f, 0.f}, v1[3] = {0.f, 0.f, 0.f};
          float dv[3] = {0.f, 0.f, 0.f}, ds[3] = {0.f, 0.f, 0.f};
          // per axis and current cell: with bf16 the lo and hi sums; in f32
          // the sums of g' and of g' * fr, whose difference is lo
          float lo[3] = {0.f, 0.f, 0.f}, hi[3] = {0.f, 0.f, 0.f};
          auto flush = [&](int a) {
            float* row = dst + (size_t)(a * res + cell[a]) * rs;
            atomicAdd(row, BF16 ? lo[a] : lo[a] - hi[a]);
            atomicAdd(row + rs, hi[a]);
          };
          // item k of the run, in the cells set up for it
          auto item = [&](auto kc, const float (&fr)[3]) {
            constexpr int k = decltype(kc)::value;
            float go[3];
            if (BF16) {
              // g' = g * feat_b * feat_c is rounded to bf16 below, so it is
              // computed as the plain version computes it, to the bit
              float feat[3];
#pragma unroll
              for (int a = 0; a < 3; ++a) feat[a] = lerp_rn(v0[a], v1[a], fr[a]);
#pragma unroll
              for (int a = 0; a < 3; ++a) go[a] = gr[k] * feat[(a + 1) % 3] * feat[(a + 2) % 3];
            } else {
              const float fx = fmaf(dv[0], fr[0], v0[0]);
              const float fy = fmaf(dv[1], fr[1], v0[1]);
              const float fz = fmaf(dv[2], fr[2], v0[2]);
              const float gx = gr[k] * fx;
              go[0] = gr[k] * (fy * fz);
              go[1] = gx * fz;
              go[2] = gx * fy;
            }
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              dp[k][a] = fmaf(go[a], ds[a], dp[k][a]);
              if (BF16) {
                const float gb = round_bf16(go[a]);
                lo[a] = fmaf(gb, round_bf16(1.f - fr[a]), lo[a]);
                hi[a] = fmaf(gb, round_bf16(fr[a]), hi[a]);
              } else {
                lo[a] += go[a];
                hi[a] = fmaf(go[a], fr[a], hi[a]);
              }
            }
            if (k == R / 2 - 1 && has_next) load_half<R, 0>(gr, row_n, p0_n, n, vec);
            if (k == R - 1 && has_next) load_half<R, 1>(gr, row_n, p0_n, n, vec);
          };
          // set up the cells of `key`, flushing the axes whose cell changes
          auto enter = [&](int key) {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              const int i0 = (key >> (8 * a)) & 0xff;
              if (i0 != cell[a]) {
                if (cell[a] >= 0) flush(a);
                cell[a] = i0;
                const float* line = src + (size_t)a * nf * CP_PAD_R + i0;
                v0[a] = __ldg(line);
                v1[a] = __ldg(line + 1);
                dv[a] = v1[a] - v0[a];
                ds[a] = dv[a] * scale;
                lo[a] = hi[a] = 0.f;
              }
            }
          };
          int cur = cl[0].x;
          enter(cur);
          static_for<R>([&](auto kc) {
            const int4 c = cl[decltype(kc)::value];
            if (c.x != cur) {  // rare on ray-ordered points
              cur = c.x;
              enter(cur);
            }
            const float fr[3] = {__int_as_float(c.y), __int_as_float(c.z), __int_as_float(c.w)};
            item(kc, fr);
          });
#pragma unroll
          for (int a = 0; a < 3; ++a) flush(a);
        }
      }
    }
    if (LANES16) {
      float v[3 * R];
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int a = 0; a < 3; ++a) v[3 * k + a] = dp[k][a];
      const int lane = threadIdx.x & 31;
      reduce_half<3 * R, 8>(v, lane);
      reduce_half<3 * R / 2, 4>(v, lane);
      reduce_half<3 * R / 4, 2>(v, lane);
      reduce_half<3 * R / 8, 1>(v, lane);
      const int p = run * R + fl;
      const long long q = t0 + p;
      if (active && q < n) {
#pragma unroll
        for (int a = 0; a < 3; ++a) dpts[a * n + q] = live[p] >> a & 1 ? v[a] : 0.f;
      }
      continue;  // the next tile's first barrier orders the cells and masks
    }
    __syncthreads();  // every thread is done with the cells: the area takes the partial sums
    if (active) {
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int a = 0; a < 3; ++a) part[(run * R + k) * rp + a * ft + fl] = dp[k][a];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * tile; i += blockDim.x) {
      const int a = i / tile;
      const int p = i - a * tile;
      const long long q = t0 + p;
      if (q < n) {
        const float* s = part + p * rp + a * ft;
        float sum = 0.f;
        for (int j = 0; j < ft; ++j) sum += s[j];
        // zero outside the open interval: the clip has no slope there
        dpts[a * n + q] = live[p] >> a & 1 ? sum : 0.f;
      }
    }
  }
  __syncthreads();

  // one global atomic per non-zero table entry per block
  for (int l = 0; l < n_levels; ++l) {
    const int res = lv.res[l];
    for (int a = 0; a < 3; ++a) {
      float* dst = dlines + (size_t)(3 * l + a) * nf * CP_PAD_R;
      const float* src = acc + (size_t)(lv.base[l] + a * res) * rs;
      for (int idx = threadIdx.x; idx < nf * res; idx += blockDim.x) {
        const int f = idx / res;
        const int i = idx - f * res;
        const float v = src[i * rs + f];
        if (v != 0.f) atomicAdd(dst + f * CP_PAD_R + i, v);
      }
    }
  }
}

static int levels_from(const int* res, int n_levels, int nf, CpLevels* lv, int* table_floats) {
  if (n_levels < 1 || n_levels > CP_MAX_LEVELS || nf < 1) return (int)cudaErrorInvalidValue;
  int rows = 0;
  for (int l = 0; l < CP_MAX_LEVELS; ++l) {
    lv->res[l] = l < n_levels ? res[l] : 0;
    lv->base[l] = rows;
    if (l < n_levels) {
      if (res[l] < 2 || res[l] > CP_PAD_R) return (int)cudaErrorInvalidValue;
      rows += 3 * res[l];
    }
  }
  *table_floats = rows * (nf | 1);
  return 0;
}

// Blocks for `want` units of work: at most as many as fit on the card at once.
template <typename K>
static int grid_for(K kernel, long long want, int threads, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < cap ? (want > 0 ? want : 1) : cap);
  return 0;
}

extern "C" int loner_cp_fwd(const float* pts, const float* lines, float* out, long long n,
                            int n_levels, int n_features, const int* res, void* stream) {
  CpLevels lv;
  int table_floats = 0;
  int rc = levels_from(res, n_levels, n_features, &lv, &table_floats);
  if (rc) return rc;
  const size_t smem = (size_t)table_floats * sizeof(float);
  int blocks = 0;
  rc = grid_for(cp_fwd_kernel, (n + CP_THREADS - 1) / CP_THREADS, CP_THREADS, smem, &blocks);
  if (rc) return rc;
  cp_fwd_kernel<<<blocks, CP_THREADS, smem, (cudaStream_t)stream>>>(pts, lines, out, n, n_levels,
                                                                    n_features, lv);
  return (int)cudaGetLastError();
}

template <bool BF16, bool LANES16>
static int launch_bwd(const float* pts, const float* lines, const float* g, float* dlines,
                      float* dpts, long long n, int n_levels, int nf, const CpLevels& lv,
                      int table_floats, int ft, int runs, int threads, size_t smem,
                      cudaStream_t stream) {
  const long long tile = (long long)runs * CP_BWD_RUN;
  const long long n_tiles = (n + tile - 1) / tile;
  int blocks = 0;
  int rc = grid_for(cp_bwd_kernel<BF16, LANES16>, n_tiles, threads, smem, &blocks);
  if (rc) return rc;
  const long long per_block = (n_tiles + blocks - 1) / blocks;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  cp_bwd_kernel<BF16, LANES16><<<blocks, threads, smem, stream>>>(
      pts, lines, g, dlines, dpts, n, n_levels, nf, lv, table_floats, ft, runs, per_block, vec);
  return (int)cudaGetLastError();
}

// runs, threads and smem_bytes are ops/cp_kernel.py::cp_bwd_plan's (for runs of
// CP_BWD_RUN points); any other value is refused.
extern "C" int loner_cp_bwd(const float* pts, const float* lines, const float* g, float* dlines,
                            float* dpts, long long n, int n_levels, int n_features, const int* res,
                            int mm_bf16, int runs, int threads, long long smem_bytes, void* stream) {
  CpLevels lv;
  int table_floats = 0;
  int rc = levels_from(res, n_levels, n_features, &lv, &table_floats);
  if (rc) return rc;
  const int ft = n_features < CP_BWD_MAX_THREADS ? n_features : CP_BWD_MAX_THREADS;
  if (runs < 1 || runs > CP_BWD_MAX_THREADS / ft) return (int)cudaErrorInvalidValue;
  const long long tile = (long long)runs * CP_BWD_RUN;
  const bool lanes16 = n_features == 16;
  const long long cells = 4LL * n_levels * tile, parts = lanes16 ? 0 : tile * (3 * ft + 1);
  const long long want = 4LL * (((table_floats + 3) & ~3) + (cells > parts ? cells : parts) + 4 * tile);
  if (threads != (ft * runs + 31) / 32 * 32 || smem_bytes != want || want > CP_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)smem_bytes;
  if (lanes16)
    return mm_bf16 ? launch_bwd<true, true>(pts, lines, g, dlines, dpts, n, n_levels, n_features, lv,
                                            table_floats, ft, runs, threads, smem, s)
                   : launch_bwd<false, true>(pts, lines, g, dlines, dpts, n, n_levels, n_features, lv,
                                             table_floats, ft, runs, threads, smem, s);
  return mm_bf16 ? launch_bwd<true, false>(pts, lines, g, dlines, dpts, n, n_levels, n_features, lv,
                                           table_floats, ft, runs, threads, smem, s)
                 : launch_bwd<false, false>(pts, lines, g, dlines, dpts, n, n_levels, n_features, lv,
                                            table_floats, ft, runs, threads, smem, s);
}
