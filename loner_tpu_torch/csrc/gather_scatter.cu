// Row scatter-add and the table lookups of the memory probes, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of scripts/:
//  * row_scatter_add + shadow_sum: bench_pallas_scatter.py, `kernel` in
//    `_mk` (P1);
//  * row_gather: bench_gather.py `k_tala` and `k_take` (P2a, P2c, one
//    function); col_gather: bench_gather.py `k_tala_t` (P2b);
//  * lane_gather: bench_honest.py `k_lane` (P3), bench_dyngather.py `k_lane`
//    (P4b), bench_gather2.py `k_lane` (P6); sublane_gather:
//    bench_dyngather.py `k_sub` (P4a); two_stage_gather: bench_dyngather.py
//    `k2` (P4c).
//
// What bounds them on an H100: bytes. Each output element is one load of an
// index, one load of a table value and one store; a scatter row is one index,
// one update row and atomics into a table that fits in L2 (the accumulator of
// one shadow copy is T x 16 f32, 4 MB at the probe's T = 65,536). There is no
// arithmetic to speak of, so the designs are about coalescing: a warp's 32
// threads take 32 neighbouring output elements (or rows), so that index
// loads and output stores are contiguous; only the table reads are random.
//
//  * row_scatter_add: the TPU kernel carries a VMEM accumulator across its
//    sequential grid; blocks here run in parallel, so the updates are added
//    into shadow copy `row % nshadow` of a zeroed (nshadow, T, W)
//    accumulator with atomics, in f32 or in bf16 (the update rounded to
//    bf16 first). Shadow copies spread the atomics to a hot row over more
//    addresses. A second kernel sums the copies in order, in the
//    accumulator's type, four elements a thread, and writes f32; with one
//    f32 copy the wrapper hands the zeroed output over as the accumulator
//    and launches only the first. The first design, a thread and a scalar
//    atomic per element with two runtime divisions, took 11.6 us of its
//    13.8 (the fill the rest) at the probe's 262,144 rows of 16 f32, and
//    as much with plain stores for its atomics: 4.2M threads, not the
//    atomics, set its pace. Where W % 4 == 0 and upd is 16-byte aligned (the
//    vector path) a thread takes a 16-byte piece of a row, from a 2-D block
//    (pieces x rows, so no division), streams it as one float4 and adds it
//    with one vector atomic (16 bytes of f32, or 8 bytes of four bf16 each
//    rounded as the scalar path rounds): 8.3 us at the probe's shape, 6.5
//    with stores, so the atomics now cost about 1.8 us over the streaming
//    of the 16.8 MB of updates. Other W, and unaligned views, keep the
//    first design (the scalar path). Worst case: many rows on one entry
//    serialise their atomics there, as in either design.
//  * row_gather: one thread per 16-byte piece of an output row (a row of W
//    f32 moves as W/4 float4s when W is a multiple of 4 and the table starts
//    on a 16-byte boundary, which the caller decides, else as floats), so
//    that each store instruction of a warp writes 512 contiguous bytes (one
//    thread per 32-byte row writes them with two half-filled instructions);
//    streaming stores, since the output is not read back here.
//  * col_gather and two_stage_gather: their first designs, one thread per
//    output element, ran at 23% and 43% of their byte bounds. Timed on
//    indices that hit one sector (PERF.md section 6), they fell from 0.115
//    to 0.048 ms and from 0.107 to 0.070 ms: random lookups were about half
//    the time, per-element work the rest (col_gather read idx once per
//    column; two_stage_gather chained three dependent loads). What a random
//    4-byte lookup costs here is one request for a 32-byte L2 sector: the
//    card serves about 138 G of them a second from a 2 MB table (the
//    marginal cost of two_stage_gather's distinct lookups, chip_smoke.py).
//    Lookups that repeat an address within a warp or hit L1 cost little,
//    so the count that matters is distinct sectors.
//  * col_gather, one call = two launches. A first kernel writes table_t
//    (W, T) transposed into the wrapper's (T, W4) scratch (W rounded up to
//    a multiple of 4, pad columns zero) through a 32 x 32 shared tile, so
//    that reads and writes are both coalesced. The gather then gives each
//    block 256 points: it reads their indices once, fetches each point's
//    row of the scratch as float4s (one sector a point at W = 8, where the
//    column-major design paid W sectors and read idx W times) into a
//    (band, 256 + 4) shared tile, and writes the band's rows of out as
//    float4 streaming stores (scalar ones when N % 4 != 0, which float4
//    rows of out need). Columns go in bands of 32, so any W takes at most
//    33 KB of shared memory. Bound by bytes again (69% of the bound at the
//    probe's shape); worst case: a point's row takes W / 8 sectors, whatever
//    the indices.
//  * two_stage_gather: out[c, i, j] depends on its row (c, i) and on
//    m = idx[c, i, j] mod C alone, so a row has at most C distinct values
//    v[m] = tab[idx[c, i, m], m]. A warp takes a row: it marks in shared
//    memory the m its elements use, reads v only for the marked m (about
//    81 of 128 at the probe's uniform draws), then writes v[m_j] for each
//    j (int4 index loads and float4 streaming stores when C % 4 == 0 and
//    both are 16-byte aligned). A row of at most 64 V columns stays in the
//    lanes' registers, read from device memory once; a longer one goes in
//    pieces of 1024 m, each pass reading the row again (from L1), so any C
//    fits in 40 KB of shared memory. The first design's duplicate lookups
//    already hit L1, so the distinct lookups, at the card's sector rate,
//    bound both designs: 12M of them at the probe's shape take 0.086 ms of
//    the 0.107. Worst case: a row whose m are all distinct reads C values,
//    one per element, as the first design did.
//  * lane_gather: one thread per output element.
//  * sublane_gather, out[i, j] = tab[idx[i, j], j]: one thread per element,
//    bound by its lookups, one 32-byte L2 sector each: at the probe's
//    (4096, 128) slab, 5.7 us on uniform draws, 2.5 with every index equal,
//    2.0 for an empty kernel of its grid (loner_empty_grid). A design that
//    held a band of 8 columns in the shared memory of each CTA of a
//    thread-block cluster (TMA copies multicast over the cluster) was
//    slower there, 11 us: every SM must still take in its whole band as
//    one 32-byte request a row, no faster than random lookups (PERF.md
//    section 6). Worst case: lookups spread over a table larger than
//    L2.
//
// Indices are in range by construction in every probe; the kernels do not
// check them (the plain CPU versions, torch.gather and indexing, raise on a
// bad index).
//
// Offsets are 32-bit: a 64-bit division by a runtime width costs tens of
// instructions per element. Every C entry refuses (cudaErrorInvalidValue)
// a tensor of 2^31 elements or more; the probes' largest holds 18.9M.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define GS_THREADS 256

typedef unsigned int u32;

static bool fits32(unsigned long long count) { return count < (1ULL << 31); }

// one thread per element, below 2^31 elements: fewer than 2^23 blocks
static unsigned int blocks_for(long long n) { return (unsigned int)((n + GS_THREADS - 1) / GS_THREADS); }

#define THREAD_ELEMENT(e, total)                    \
  const u32 e = blockIdx.x * blockDim.x + threadIdx.x; \
  if (e >= (total)) return

// ---------------------------------------------------------------------------
// P1: row scatter-add into shadow copies, then their sum
// ---------------------------------------------------------------------------

__device__ __forceinline__ void add_to(float* a, float v) { atomicAdd(a, v); }
__device__ __forceinline__ void add_to(__nv_bfloat16* a, float v) { atomicAdd(a, __float2bfloat16_rn(v)); }

// four neighbouring elements in one vector atomic (global memory, sm_90):
// f32 as one 16-byte add; bf16 rounded first, as the scalar path does, then
// one 8-byte add of four bf16s, each sum rounded to bf16
__device__ __forceinline__ void add4(float* a, float4 v) { atomicAdd((float4*)a, v); }
__device__ __forceinline__ void add4(__nv_bfloat16* a, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  asm volatile("red.global.add.noftz.v2.bf16x2 [%0], {%1, %2};" ::"l"(__cvta_generic_to_global(a)),
               "r"(*(const u32*)&lo), "r"(*(const u32*)&hi)
               : "memory");
}

// scalar path (W % 4 != 0, or upd not 16-byte aligned): thread e adds
// upd[e] (row i = e / w, column c) into shadow i % nshadow
template <typename Acc>
__global__ void row_scatter_add_kernel(const int* __restrict__ idx, const float* __restrict__ upd,
                                       Acc* __restrict__ acc, u32 n, u32 t, u32 w, u32 nshadow) {
  THREAD_ELEMENT(e, n * w);
  const u32 i = e / w;
  const u32 c = e - i * w;
  add_to(acc + ((i % nshadow) * t + (u32)idx[i]) * w + c, upd[e]);
}

// vector path: thread (x, y) of a (bx, by) block adds the 16-byte pieces x,
// x + bx, ... of row i = by blockIdx.x + y (wv pieces a row) into shadow
// i % nshadow; no division per element, upd streamed as float4s
template <typename Acc>
__global__ void row_scatter_add_vec_kernel(const int* __restrict__ idx, const float4* __restrict__ upd,
                                           Acc* __restrict__ acc, u32 n, u32 t, u32 wv, u32 nshadow) {
  const u32 i = blockIdx.x * blockDim.y + threadIdx.y;
  if (i >= n) return;
  const u32 s = (nshadow & (nshadow - 1)) ? i % nshadow : i & (nshadow - 1);
  Acc* row = acc + (s * t + (u32)__ldg(idx + i)) * wv * 4;
  const float4* u = upd + i * wv;
  for (u32 q = threadIdx.x; q < wv; q += blockDim.x) add4(row + 4 * q, __ldcs(u + q));
}

// out = acc[0] + acc[1] + ... in that order; in bf16 every partial sum is
// rounded to bf16, as a sum of bf16 arrays is. V elements a thread (4: tw %
// 4 == 0, float4 loads and stores, 8-byte bf16 loads)
__device__ __forceinline__ float rounded(float x, const float*) { return x; }
__device__ __forceinline__ float rounded(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void load_acc(const float* p, float (&x)[1]) { x[0] = __ldcs(p); }
__device__ __forceinline__ void load_acc(const __nv_bfloat16* p, float (&x)[1]) { x[0] = __bfloat162float(*p); }
__device__ __forceinline__ void load_acc(const float* p, float (&x)[4]) {
  const float4 v = __ldcs((const float4*)p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load_acc(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = __ldcs((const uint2*)p);
  const float2 lo = __bfloat1622float2(*(const __nv_bfloat162*)&v.x);
  const float2 hi = __bfloat1622float2(*(const __nv_bfloat162*)&v.y);
  x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
}
__device__ __forceinline__ void store_out(float* p, const float (&x)[1]) { p[0] = x[0]; }
__device__ __forceinline__ void store_out(float* p, const float (&x)[4]) {
  *(float4*)p = make_float4(x[0], x[1], x[2], x[3]);
}

template <typename Acc, int V>
__global__ void shadow_sum_kernel(const Acc* __restrict__ acc, float* __restrict__ out, u32 tw, u32 nshadow) {
  THREAD_ELEMENT(e, tw / V);
  float tot[V], x[V];
  load_acc(acc + V * e, tot);
  for (u32 s = 1; s < nshadow; ++s) {
    load_acc(acc + s * tw + V * e, x);
#pragma unroll
    for (int k = 0; k < V; ++k) tot[k] = rounded(__fadd_rn(tot[k], x[k]), acc);
  }
  store_out(out + V * e, tot);
}

// ---------------------------------------------------------------------------
// P2: row and column gathers of a (T, W) table
// ---------------------------------------------------------------------------

// thread e moves piece e of the output, a piece being a float4 or a float:
// row p = e / wv of the output, wv pieces a row. The output is written once
// and not read back: streaming stores.
template <typename V>
__global__ void row_gather_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                                  V* __restrict__ out, u32 total, u32 wv) {
  THREAD_ELEMENT(e, total);
  const u32 p = e / wv;
  __stcs(out + e, __ldg(table + (u32)__ldg(idx + p) * wv + (e - p * wv)));
}

#define CG_POINTS 256              // points (and threads) a gather block
#define CG_BAND 32                 // columns a band of the gather's tile, a multiple of 4
#define CG_STRIDE (CG_POINTS + 4)  // tile row stride: float4 rows, 4 banks apart

// block (x, y) writes rows t0 = 32 x .. of tt (T, w4), columns c0 = 32 y ..:
// tt[t, c] = table_t[c, t], zero for the pad columns c >= w
__global__ void transpose_kernel(const float* __restrict__ table_t, float* __restrict__ tt, u32 t, u32 w, u32 w4) {
  __shared__ float tile[32][33];
  const u32 t0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const u32 tw = min(32u, t - t0), cw = min(32u, w4 - c0);
  for (u32 k = threadIdx.x; k < cw * 32; k += blockDim.x) {
    const u32 cc = k >> 5, r = k & 31;
    tile[cc][r] = (c0 + cc < w && r < tw) ? table_t[(c0 + cc) * t + t0 + r] : 0.f;
  }
  __syncthreads();
  for (u32 k = threadIdx.x; k < tw * cw; k += blockDim.x) {  // at w4 <= 32 one contiguous span of tt
    const u32 r = k / cw, cc = k - r * cw;
    tt[(t0 + r) * w4 + c0 + cc] = tile[cc][r];
  }
}

// out (W, N): out[c, p] = tt[idx[p], c]. Block b takes points p0 = 256 b ..;
// band by band of columns, each point's row piece moves as float4s into
// tile[c][p], then the band's rows of out are written from the tile. VEC:
// float4 stores (n % 4 == 0 and out 16-byte aligned).
template <bool VEC>
__global__ void col_gather_kernel(const float4* __restrict__ tt, const int* __restrict__ idx,
                                  float* __restrict__ out, u32 n, u32 w, u32 w4) {
  extern __shared__ float4 cg_tile[];  // min(w4, CG_BAND) rows of CG_STRIDE floats
  __shared__ u32 rows[CG_POINTS];
  float* tile = (float*)cg_tile;
  const u32 p0 = blockIdx.x * CG_POINTS, np = min((u32)CG_POINTS, n - p0), r4 = w4 / 4;
  if (threadIdx.x < np) rows[threadIdx.x] = (u32)__ldcs(idx + p0 + threadIdx.x);
  for (u32 b0 = 0; b0 < w4; b0 += CG_BAND) {
    const u32 nv = min((u32)CG_BAND, w4 - b0) / 4;  // float4s a row piece
    __syncthreads();  // rows staged; the last band written out
    for (u32 q = threadIdx.x; q < np * nv; q += CG_POINTS) {
      const u32 p = q / nv, v = q - p * nv;  // neighbouring threads: one row's float4s
      const float4 x = __ldg(tt + rows[p] * r4 + b0 / 4 + v);
      float* col = tile + 4 * v * CG_STRIDE + p;
      col[0] = x.x;
      col[CG_STRIDE] = x.y;
      col[2 * CG_STRIDE] = x.z;
      col[3 * CG_STRIDE] = x.w;
    }
    __syncthreads();
    const u32 cw = min((u32)CG_BAND, w - b0);  // real columns of the band
    if (VEC) {
      for (u32 q = threadIdx.x; q < cw * (CG_POINTS / 4); q += CG_POINTS) {
        const u32 cc = q / (CG_POINTS / 4), j = q % (CG_POINTS / 4);
        if (4 * j < np)
          __stcs((float4*)(out + (b0 + cc) * n + p0) + j, *(const float4*)(tile + cc * CG_STRIDE + 4 * j));
      }
    } else {
      for (u32 q = threadIdx.x; q < cw * CG_POINTS; q += CG_POINTS) {
        const u32 cc = q / CG_POINTS, p = q % CG_POINTS;
        if (p < np) __stcs(out + (b0 + cc) * n + p0 + p, tile[cc * CG_STRIDE + p]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// P3-P6: lookups in a (rows, cols) table
// ---------------------------------------------------------------------------

// out[i, j] = tab[i, idx[i, j]]
__global__ void lane_gather_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                                   float* __restrict__ out, u32 total, u32 cols) {
  THREAD_ELEMENT(e, total);
  out[e] = tab[e - e % cols + (u32)idx[e]];
}

// out[i, j] = tab[idx[i, j], j]
__global__ void sublane_gather_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                                      float* __restrict__ out, u32 total, u32 cols) {
  THREAD_ELEMENT(e, total);
  out[e] = tab[(u32)idx[e] * cols + e % cols];
}

// does nothing: the launch floor of a grid, for the probes' timings
__global__ void empty_kernel() {}

#define TS_WARPS 8     // warps a block, a row each
#define TS_Q 2         // a short row, at most 32 x V x TS_Q columns, stays in registers
#define TS_PIECE 1024  // columns m a warp holds values of at once in a longer row

__device__ __forceinline__ void load_ints(const int* p, int (&e)[1]) { e[0] = __ldg(p); }
__device__ __forceinline__ void load_ints(const int* p, int (&e)[4]) {
  const int4 x = __ldg((const int4*)p);
  e[0] = x.x, e[1] = x.y, e[2] = x.z, e[3] = x.w;
}
__device__ __forceinline__ void store_floats(float* p, const float (&f)[1]) { __stcs(p, f[0]); }
__device__ __forceinline__ void store_floats(float* p, const float (&f)[4]) {
  __stcs((float4*)p, make_float4(f[0], f[1], f[2], f[3]));
}

// where v[m] lives: a pad word after every 32, so that a lane's stores of
// its V neighbouring m meet no bank conflict
__device__ __forceinline__ u32 vpad(u32 m) { return m + (m >> 5); }

// out[r, j] = v[m_j], v[m] = tab[idx[r, m] * cols + m], m_j = idx[r, j] mod
// cols, for the nrows rows r of idx (K x R of them), a warp a row, for rows
// of at most 32 V Q columns. Lane l holds the row's elements j = V (32 s +
// l) + k, k < V, s < Q, and their m in registers: it marks its m, reads v
// at its own j where marked, then writes v[m_j] for its j. V elements at
// once (4: int4 loads and float4 stores).
template <int V, int Q>
__global__ void two_stage_short_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                                       float* __restrict__ out, u32 nrows, u32 cols) {
  constexpr u32 width = 32 * V * Q, vwidth = width + width / 32;
  extern __shared__ float ts_smem[];  // TS_WARPS x vwidth values, then TS_WARPS x width marks
  const u32 warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const u32 row = blockIdx.x * TS_WARPS + warp;
  if (row >= nrows) return;  // warp-uniform; no block barrier follows
  float* v = ts_smem + warp * vwidth;
  unsigned char* used = (unsigned char*)(ts_smem + TS_WARPS * vwidth) + warp * width;
  const int* ir = idx + row * cols;
  int e[Q][V] = {};
  u32 m[Q][V];
#pragma unroll
  for (int s = 0; s < Q; ++s)
    if ((32 * s + lane) * V < cols) load_ints(ir + (32 * s + lane) * V, e[s]);
  for (u32 k = lane; k < width / 4; k += 32) ((u32*)used)[k] = 0;
  __syncwarp();
#pragma unroll
  for (int s = 0; s < Q; ++s)
#pragma unroll
    for (int k = 0; k < V; ++k) {
      m[s][k] = (u32)e[s][k] % cols;
      if ((32 * s + lane) * V < cols) used[m[s][k]] = 1;
    }
  __syncwarp();
  float x[Q][V];
#pragma unroll
  for (int s = 0; s < Q; ++s)
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const u32 j = (32 * s + lane) * V + k;
      if (j < cols && used[j]) x[s][k] = __ldg(tab + (u32)e[s][k] * cols + j);
    }
#pragma unroll
  for (int s = 0; s < Q; ++s)
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const u32 j = (32 * s + lane) * V + k;
      if (j < cols && used[j]) v[vpad(j)] = x[s][k];
    }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    const u32 q = (32 * s + lane) * V;
    if (q < cols) {
      float f[V];
#pragma unroll
      for (int k = 0; k < V; ++k) f[k] = v[vpad(m[s][k])];
      store_floats(out + row * cols + q, f);
    }
  }
}

// The same for a longer row, piece by piece of TS_PIECE columns m: mark the
// m_j in the piece, read v[m] for the marked m, write the elements whose
// m_j is in it; each pass reads the row's indices again (from L1).
template <int V>
__global__ void two_stage_long_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                                      float* __restrict__ out, u32 nrows, u32 cols) {
  extern __shared__ float ts_smem[];  // TS_WARPS x TS_PIECE values, then as many marks
  const u32 warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const u32 row = blockIdx.x * TS_WARPS + warp;
  if (row >= nrows) return;  // warp-uniform; no block barrier follows
  float* v = ts_smem + warp * TS_PIECE;
  unsigned char* used = (unsigned char*)(ts_smem + TS_WARPS * TS_PIECE) + warp * TS_PIECE;
  const int* ir = idx + row * cols;
  float* orow = out + row * cols;
  for (u32 m0 = 0; m0 < cols; m0 += TS_PIECE) {
    const u32 pw = min((u32)TS_PIECE, cols - m0);
    for (u32 k = lane; k < pw; k += 32) used[k] = 0;
    __syncwarp();
    for (u32 q = lane * V; q < cols; q += 32 * V) {
      int e[V];
      load_ints(ir + q, e);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const u32 m = (u32)e[k] % cols - m0;  // wraps past pw below m0
        if (m < pw) used[m] = 1;
      }
    }
    __syncwarp();
    for (u32 k0 = lane; k0 < pw; k0 += 4 * 32) {  // four lookups in flight a lane
      float x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const u32 k = k0 + 32 * u;
        if (k < pw && used[k]) x[u] = __ldg(tab + (u32)__ldg(ir + m0 + k) * cols + m0 + k);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const u32 k = k0 + 32 * u;
        if (k < pw && used[k]) v[k] = x[u];
      }
    }
    __syncwarp();
    for (u32 q = lane * V; q < cols; q += 32 * V) {
      int e[V];
      load_ints(ir + q, e);
      if (pw == cols) {
        float f[V];
#pragma unroll
        for (int k = 0; k < V; ++k) f[k] = v[(u32)e[k] % cols];
        store_floats(orow + q, f);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const u32 m = (u32)e[k] % cols - m0;
          if (m < pw) __stcs(orow + q + k, v[m]);
        }
      }
    }
    __syncwarp();  // the next piece overwrites v and the marks
  }
}

// ---------------------------------------------------------------------------
// C entry points: launch on `stream`, allocate nothing, return
// cudaGetLastError(); cudaErrorInvalidValue for a tensor of 2^31 elements or
// more
// ---------------------------------------------------------------------------

#define STREAM(s) (cudaStream_t)(s)

static bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

// vec: the vector path; the caller sets it only when w is a multiple of 4 and
// upd is 16-byte aligned (acc comes from the allocator)
extern "C" int loner_row_scatter_add(const int* idx, const float* upd, void* acc, long long n,
                                     long long t, long long w, int nshadow, int acc_bf16, int vec,
                                     void* stream) {
  if (nshadow < 1 || w < 1 || t < 1 || !fits32(n * w) || !fits32((unsigned long long)nshadow * t * w) ||
      (vec && (w % 4 || !aligned16(upd) || !aligned16(acc))))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const cudaStream_t s = STREAM(stream);
  if (vec) {
    const u32 wv = (u32)(w / 4), bx = wv < GS_THREADS ? wv : GS_THREADS, by = GS_THREADS / bx;
    const dim3 block(bx, by);
    const unsigned int blocks = (unsigned int)((n + by - 1) / by);
    if (acc_bf16)
      row_scatter_add_vec_kernel<<<blocks, block, 0, s>>>(idx, (const float4*)upd, (__nv_bfloat16*)acc, (u32)n,
                                                          (u32)t, wv, (u32)nshadow);
    else
      row_scatter_add_vec_kernel<<<blocks, block, 0, s>>>(idx, (const float4*)upd, (float*)acc, (u32)n, (u32)t,
                                                          wv, (u32)nshadow);
  } else if (acc_bf16) {
    row_scatter_add_kernel<<<blocks_for(n * w), GS_THREADS, 0, s>>>(idx, upd, (__nv_bfloat16*)acc, (u32)n,
                                                                     (u32)t, (u32)w, (u32)nshadow);
  } else {
    row_scatter_add_kernel<<<blocks_for(n * w), GS_THREADS, 0, s>>>(idx, upd, (float*)acc, (u32)n, (u32)t,
                                                                     (u32)w, (u32)nshadow);
  }
  return (int)cudaGetLastError();
}

// four elements a thread when tw % 4 == 0 (acc and out come from the allocator)
extern "C" int loner_shadow_sum(const void* acc, float* out, long long tw, int nshadow, int acc_bf16,
                                void* stream) {
  if (nshadow < 1 || !fits32((unsigned long long)tw * nshadow)) return (int)cudaErrorInvalidValue;
  if (tw <= 0) return 0;
  const cudaStream_t s = STREAM(stream);
  const bool vec = tw % 4 == 0 && aligned16(acc) && aligned16(out);
  const unsigned int blocks = blocks_for(vec ? tw / 4 : tw);
  if (acc_bf16 && vec)
    shadow_sum_kernel<__nv_bfloat16, 4><<<blocks, GS_THREADS, 0, s>>>((const __nv_bfloat16*)acc, out, (u32)tw,
                                                                      (u32)nshadow);
  else if (acc_bf16)
    shadow_sum_kernel<__nv_bfloat16, 1><<<blocks, GS_THREADS, 0, s>>>((const __nv_bfloat16*)acc, out, (u32)tw,
                                                                      (u32)nshadow);
  else if (vec)
    shadow_sum_kernel<float, 4><<<blocks, GS_THREADS, 0, s>>>((const float*)acc, out, (u32)tw, (u32)nshadow);
  else
    shadow_sum_kernel<float, 1><<<blocks, GS_THREADS, 0, s>>>((const float*)acc, out, (u32)tw, (u32)nshadow);
  return (int)cudaGetLastError();
}

// vec4: move rows as float4s; the caller sets it only when w is a multiple
// of 4 and table is 16-byte aligned (out comes from the allocator)
extern "C" int loner_row_gather(const float* table, const int* idx, float* out, long long n,
                                long long t, long long w, int vec4, void* stream) {
  if (w < 1 || t < 1 || (vec4 && w % 4) || !fits32(n * w) || !fits32(t * w)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const long long wv = vec4 ? w / 4 : w;
  const long long total = n * wv;
  if (vec4)
    row_gather_kernel<<<blocks_for(total), GS_THREADS, 0, STREAM(stream)>>>(
        (const float4*)table, idx, (float4*)out, (u32)total, (u32)wv);
  else
    row_gather_kernel<<<blocks_for(total), GS_THREADS, 0, STREAM(stream)>>>(table, idx, out, (u32)total,
                                                                             (u32)wv);
  return (int)cudaGetLastError();
}

// tt: the caller's (t, w4) scratch, w4 = w rounded up to a multiple of 4
extern "C" int loner_col_gather(const float* table_t, const int* idx, float* tt, float* out, long long n,
                                long long t, long long w, void* stream) {
  const long long w4 = (w + 3) / 4 * 4;
  if (w < 1 || w > 65535 || t < 1 || !fits32(n * w) || !fits32(t * w4) || !aligned16(tt))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const dim3 tgrid((unsigned int)((t + 31) / 32), (unsigned int)((w4 + 31) / 32));
  transpose_kernel<<<tgrid, GS_THREADS, 0, STREAM(stream)>>>(table_t, tt, (u32)t, (u32)w, (u32)w4);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const unsigned int blocks = (unsigned int)((n + CG_POINTS - 1) / CG_POINTS);
  const size_t smem = (size_t)(w4 < CG_BAND ? w4 : CG_BAND) * CG_STRIDE * sizeof(float);
  if (n % 4 == 0 && aligned16(out))
    col_gather_kernel<true><<<blocks, CG_POINTS, smem, STREAM(stream)>>>((const float4*)tt, idx, out, (u32)n,
                                                                          (u32)w, (u32)w4);
  else
    col_gather_kernel<false><<<blocks, CG_POINTS, smem, STREAM(stream)>>>((const float4*)tt, idx, out, (u32)n,
                                                                           (u32)w, (u32)w4);
  return (int)cudaGetLastError();
}

extern "C" int loner_lane_gather(const float* tab, const int* idx, float* out, long long rows,
                                 long long cols, void* stream) {
  const long long total = rows * cols;
  if (!fits32(total)) return (int)cudaErrorInvalidValue;
  if (total <= 0) return 0;
  lane_gather_kernel<<<blocks_for(total), GS_THREADS, 0, STREAM(stream)>>>(tab, idx, out, (u32)total,
                                                                            (u32)cols);
  return (int)cudaGetLastError();
}

extern "C" int loner_sublane_gather(const float* tab, const int* idx, float* out, long long rows,
                                    long long cols, void* stream) {
  const long long total = rows * cols;
  if (!fits32(total)) return (int)cudaErrorInvalidValue;
  if (total <= 0) return 0;
  sublane_gather_kernel<<<blocks_for(total), GS_THREADS, 0, STREAM(stream)>>>(tab, idx, out, (u32)total,
                                                                               (u32)cols);
  return (int)cudaGetLastError();
}

extern "C" int loner_two_stage_gather(const float* tab, const int* idx, float* out, long long chunks,
                                      long long rows, long long cols, void* stream) {
  const long long nrows = chunks * rows, total = nrows * cols;
  if (!fits32(total)) return (int)cudaErrorInvalidValue;
  if (total <= 0) return 0;
  const bool vec = cols % 4 == 0 && aligned16(idx) && aligned16(out);
  const long long width = 32LL * (vec ? 4 : 1) * TS_Q;  // the widest short row
  const unsigned int blocks = (unsigned int)((nrows + TS_WARPS - 1) / TS_WARPS);
  const size_t smem = cols <= width ? TS_WARPS * (size_t)(width + width / 32) * sizeof(float) + TS_WARPS * width
                                    : TS_WARPS * (size_t)TS_PIECE * (sizeof(float) + 1);
  const cudaStream_t s = STREAM(stream);
  const u32 nr = (u32)nrows, c = (u32)cols;
  if (cols <= width && vec)
    two_stage_short_kernel<4, TS_Q><<<blocks, TS_WARPS * 32, smem, s>>>(tab, idx, out, nr, c);
  else if (cols <= width)
    two_stage_short_kernel<1, TS_Q><<<blocks, TS_WARPS * 32, smem, s>>>(tab, idx, out, nr, c);
  else if (vec)
    two_stage_long_kernel<4><<<blocks, TS_WARPS * 32, smem, s>>>(tab, idx, out, nr, c);
  else
    two_stage_long_kernel<1><<<blocks, TS_WARPS * 32, smem, s>>>(tab, idx, out, nr, c);
  return (int)cudaGetLastError();
}

// an empty kernel of `blocks` blocks of GS_THREADS threads
extern "C" int loner_empty_grid(long long blocks, void* stream) {
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  empty_kernel<<<(unsigned int)blocks, GS_THREADS, 0, STREAM(stream)>>>();
  return (int)cudaGetLastError();
}
