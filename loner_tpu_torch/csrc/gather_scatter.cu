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
//    sequential grid; blocks here run in parallel, so one thread per (row,
//    column) of the updates adds its value into shadow copy `row % nshadow`
//    of a zeroed (nshadow, T, W) accumulator with atomicAdd, in f32 or in
//    bf16 (the update rounded to bf16 first). Shadow copies spread the
//    atomics to a hot row over more addresses. A second kernel sums the
//    copies in order, in the accumulator's type, and writes f32; with one
//    f32 copy the wrapper hands the zeroed output over as the accumulator
//    and launches only the first.
//  * row_gather: one thread per 16-byte piece of an output row (a row of W
//    f32 moves as W/4 float4s when W is a multiple of 4 and the table starts
//    on a 16-byte boundary, which the caller decides, else as floats), so
//    that each store instruction of a warp writes 512 contiguous bytes (one
//    thread per 32-byte row writes them with two half-filled instructions);
//    streaming stores, since the output is not read back here.
//  * col_gather: one thread per (column, point), the column on the grid's y
//    axis, so that neighbouring points store to neighbouring addresses. Each
//    4-byte lookup still moves a whole 32-byte sector from L2, W times per
//    point where row_gather moves one row: this layout pays in L2 traffic
//    what the byte bound does not count.
//  * lane, sublane and two-stage gathers: one thread per output element.
//    The two-stage lookup is fused: it reads idx twice and tab once and never
//    materialises the intermediate of the first stage.
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

// thread e adds upd[e] (row i = e / w, column c) into shadow i % nshadow
template <typename Acc>
__global__ void row_scatter_add_kernel(const int* __restrict__ idx, const float* __restrict__ upd,
                                       Acc* __restrict__ acc, u32 n, u32 t, u32 w, u32 nshadow) {
  THREAD_ELEMENT(e, n * w);
  const u32 i = e / w;
  const u32 c = e - i * w;
  add_to(acc + ((i % nshadow) * t + (u32)idx[i]) * w + c, upd[e]);
}

// out = acc[0] + acc[1] + ... in that order; in bf16 every partial sum is
// rounded to bf16, as a sum of bf16 arrays is
__global__ void shadow_sum_f32(const float* __restrict__ acc, float* __restrict__ out, u32 tw, u32 nshadow) {
  THREAD_ELEMENT(e, tw);
  float tot = acc[e];
  for (u32 s = 1; s < nshadow; ++s) tot = __fadd_rn(tot, acc[s * tw + e]);
  out[e] = tot;
}

__global__ void shadow_sum_bf16(const __nv_bfloat16* __restrict__ acc, float* __restrict__ out, u32 tw,
                                u32 nshadow) {
  THREAD_ELEMENT(e, tw);
  float tot = __bfloat162float(acc[e]);
  for (u32 s = 1; s < nshadow; ++s)
    tot = __bfloat162float(__float2bfloat16_rn(__fadd_rn(tot, __bfloat162float(acc[s * tw + e]))));
  out[e] = tot;
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

// out (W, N): out[c, p] = table_t[c, idx[p]], table_t (W, T); column c is
// the grid's y index
__global__ void col_gather_kernel(const float* __restrict__ table_t, const int* __restrict__ idx,
                                  float* __restrict__ out, u32 n, u32 t) {
  THREAD_ELEMENT(p, n);
  const u32 c = blockIdx.y;
  out[c * n + p] = table_t[c * t + (u32)idx[p]];
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

// out[c, i, j] = tab[idx[c, i, m], m] with m = idx[c, i, j] mod cols
__global__ void two_stage_gather_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                                        float* __restrict__ out, u32 total, u32 cols) {
  THREAD_ELEMENT(e, total);
  const u32 m = (u32)idx[e] % cols;
  out[e] = tab[(u32)idx[e - e % cols + m] * cols + m];  // e - e % cols: first element of e's row
}

// ---------------------------------------------------------------------------
// C entry points: launch on `stream`, allocate nothing, return
// cudaGetLastError(); cudaErrorInvalidValue for a tensor of 2^31 elements or
// more
// ---------------------------------------------------------------------------

#define STREAM(s) (cudaStream_t)(s)

extern "C" int loner_row_scatter_add(const int* idx, const float* upd, void* acc, long long n,
                                     long long t, long long w, int nshadow, int acc_bf16,
                                     void* stream) {
  if (nshadow < 1 || w < 1 || t < 1 || !fits32(n * w) || !fits32((unsigned long long)nshadow * t * w))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  if (acc_bf16)
    row_scatter_add_kernel<<<blocks_for(n * w), GS_THREADS, 0, STREAM(stream)>>>(
        idx, upd, (__nv_bfloat16*)acc, (u32)n, (u32)t, (u32)w, (u32)nshadow);
  else
    row_scatter_add_kernel<<<blocks_for(n * w), GS_THREADS, 0, STREAM(stream)>>>(
        idx, upd, (float*)acc, (u32)n, (u32)t, (u32)w, (u32)nshadow);
  return (int)cudaGetLastError();
}

extern "C" int loner_shadow_sum(const void* acc, float* out, long long tw, int nshadow, int acc_bf16,
                                void* stream) {
  if (nshadow < 1 || !fits32((unsigned long long)tw * nshadow)) return (int)cudaErrorInvalidValue;
  if (tw <= 0) return 0;
  if (acc_bf16)
    shadow_sum_bf16<<<blocks_for(tw), GS_THREADS, 0, STREAM(stream)>>>((const __nv_bfloat16*)acc, out,
                                                                        (u32)tw, (u32)nshadow);
  else
    shadow_sum_f32<<<blocks_for(tw), GS_THREADS, 0, STREAM(stream)>>>((const float*)acc, out, (u32)tw,
                                                                       (u32)nshadow);
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

extern "C" int loner_col_gather(const float* table_t, const int* idx, float* out, long long n,
                                long long t, long long w, void* stream) {
  if (w < 1 || w > 65535 || t < 1 || !fits32(n * w) || !fits32(t * w)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const dim3 grid(blocks_for(n), (unsigned int)w);
  col_gather_kernel<<<grid, GS_THREADS, 0, STREAM(stream)>>>(table_t, idx, out, (u32)n, (u32)t);
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
  const long long total = chunks * rows * cols;
  if (!fits32(total)) return (int)cudaErrorInvalidValue;
  if (total <= 0) return 0;
  two_stage_gather_kernel<<<blocks_for(total), GS_THREADS, 0, STREAM(stream)>>>(tab, idx, out, (u32)total,
                                                                                 (u32)cols);
  return (int)cudaGetLastError();
}
