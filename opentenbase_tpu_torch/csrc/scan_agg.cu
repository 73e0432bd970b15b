// Fused scan -> MVCC visibility -> WHERE -> grouped SUM/COUNT, per shard.
//
// Replaces the reference's Pallas TPU kernel
// opentenbase_tpu/ops/pallas_scan.py:build_partials (with its host-side
// combine_partials): the exact per-shard int64 sums [S, G, E] and counts
// [S, G] of the rows of each shard that are visible at the snapshot and
// pass the predicate, grouped by a dense joint key of at most 16 groups.
//
// What bounds it on an H100: bytes. Predicate columns are read for every
// visible row, value-only columns only in the 32-byte sectors that hold a
// passing row (ops/scan_agg.py spec_bytes: about 20.6 bytes a row for
// TPC-H Q6, where 2 % of rows pass, and 36 for Q1). A row needs a few
// dozen integer operations, far below the card's ratio of operations to
// bytes, so the least time is those bytes over the 3.35 TB/s of HBM3.
//
// Design, against the TPU kernel:
// - Columns are read at their native width (int32, int64, bool) straight
//   from the resident [S, Rmax] planes; no f32 copy and no separate
//   live-mask column. Visibility (xmin <= snap < xmax) is applied here;
//   the planes are [S, 1] (stride 0, one test per shard) or [S, Rmax].
// - All arithmetic is int64, so the f32 limb split and double-float
//   TwoSum of the TPU kernel (forced by Mosaic's 32-bit compute) are not
//   needed: the certifier bounds operands below 2^24.
// - Expressions arrive as a small stack bytecode in the kernel parameter
//   block (__grid_constant__, read through the constant cache; every
//   thread runs the same program, so there is no divergence and no
//   per-query compile). The value programs only run for rows that pass.
// - Grid (blocks_per_shard, S); consecutive threads take consecutive rows
//   (coalesced loads) and walk [0, nrows[s]) with a grid stride, skipping
//   the bucket padding. Each warp reduces its row step with shuffles per
//   (group, lane); lane 0 adds the total to the warp's slot in shared
//   memory; the block then sums the warp slots and issues one 64-bit
//   atomicAdd per (s, group, lane) into the outputs, which the wrapper
//   zeroed. Integer addition is associative, so the result does not
//   depend on the order blocks run in.
//
// Built by nvcc into a shared library with a plain C interface
// (ops/scan_agg.py: build / _load); ScanAggParams is mirrored there by a
// ctypes.Structure whose size is checked against scan_agg_params_size().

#include <cstdint>
#include <cuda_runtime.h>

#define SA_MAX_COLS 16
#define SA_MAX_CODE 256
#define SA_MAX_CONSTS 64
#define SA_MAX_VALUES 8
#define SA_MAX_GROUPS 16
#define SA_STACK 16
#define SA_THREADS 256
#define SA_WARPS (SA_THREADS / 32)
#define SA_MAX_LANES (SA_MAX_GROUPS * (SA_MAX_VALUES + 1))

// opcodes: ops/scan_agg.py OP_*
enum {
  OP_COL = 1, OP_CONST = 2, OP_ADD = 3, OP_SUB = 4, OP_MUL = 5, OP_NEG = 6,
  OP_EQ = 7, OP_NE = 8, OP_LT = 9, OP_LE = 10, OP_GT = 11, OP_GE = 12,
  OP_AND = 13, OP_OR = 14, OP_NOT = 15,
};

struct ScanAggParams {
  const void* cols[SA_MAX_COLS];  // [S, Rmax] planes, row-major
  const long long* xmin;          // [S, 1] or [S, Rmax]
  const long long* xmax;
  const long long* nrows;         // [S]
  unsigned long long* sums;       // [S, G, E] int64
  unsigned long long* counts;     // [S, G] int64
  long long consts[SA_MAX_CONSTS];
  long long rmax;
  long long mvcc_shard_stride;    // 1 (compact) or rmax
  long long mvcc_row_stride;      // 0 (compact) or 1
  long long snap;
  int col_dtype[SA_MAX_COLS];     // 0 int32, 1 int64, 2 bool
  int code[SA_MAX_CODE];          // op | arg << 8
  int pred_start, pred_len;       // len 0: every row passes
  int key_start, key_len;         // len 0: group 0
  int val_start[SA_MAX_VALUES];
  int val_len[SA_MAX_VALUES];
  int n_groups;
  int n_values;
};

__device__ __forceinline__ long long load_col(const ScanAggParams& p, int c,
                                              long long off) {
  const int dt = p.col_dtype[c];
  if (dt == 0) return (long long)__ldg((const int*)p.cols[c] + off);
  if (dt == 1) return __ldg((const long long*)p.cols[c] + off);
  return (long long)__ldg((const unsigned char*)p.cols[c] + off);
}

__device__ long long run_program(const ScanAggParams& p, int start, int len,
                                 long long off) {
  long long st[SA_STACK];
  int sp = 0;
  for (int i = start; i < start + len; ++i) {
    const int ins = p.code[i];
    const int op = ins & 0xff;
    const int arg = ins >> 8;
    if (op == OP_COL) {
      st[sp++] = load_col(p, arg, off);
    } else if (op == OP_CONST) {
      st[sp++] = p.consts[arg];
    } else if (op == OP_NEG) {
      st[sp - 1] = -st[sp - 1];
    } else if (op == OP_NOT) {
      st[sp - 1] = 1 - st[sp - 1];
    } else {
      const long long b = st[--sp];
      const long long a = st[sp - 1];
      long long r;
      switch (op) {
        case OP_ADD: r = a + b; break;
        case OP_SUB: r = a - b; break;
        case OP_MUL: r = a * b; break;
        case OP_EQ: r = a == b; break;
        case OP_NE: r = a != b; break;
        case OP_LT: r = a < b; break;
        case OP_LE: r = a <= b; break;
        case OP_GT: r = a > b; break;
        case OP_GE: r = a >= b; break;
        case OP_AND: r = a & b; break;
        default: r = a | b; break;  // OP_OR
      }
      st[sp - 1] = r;
    }
  }
  return st[0];
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(SA_THREADS)
scan_agg_kernel(const __grid_constant__ ScanAggParams p) {
  __shared__ unsigned long long warp_acc[SA_WARPS][SA_MAX_LANES];
  const int s = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = p.n_groups;
  const int E = p.n_values;
  const int L = E + 1;  // per group: E sums, then the count
  const long long n = p.nrows[s];

  // compact MVCC planes: one visibility test for the whole shard
  if (p.mvcc_row_stride == 0) {
    const long long o = (long long)s * p.mvcc_shard_stride;
    if (!(p.xmin[o] <= p.snap && p.snap < p.xmax[o])) return;
  }
  for (int i = threadIdx.x; i < SA_WARPS * SA_MAX_LANES; i += SA_THREADS)
    (&warp_acc[0][0])[i] = 0ull;
  __syncthreads();

  const long long plane = (long long)s * p.rmax;
  const long long step = (long long)gridDim.x * SA_THREADS;
  // the loop bound is uniform over the block, so whole warps take the
  // shuffles below
  for (long long base = (long long)blockIdx.x * SA_THREADS; base < n;
       base += step) {
    const long long r = base + threadIdx.x;
    bool pass = r < n;
    if (pass && p.mvcc_row_stride != 0) {
      const long long o = (long long)s * p.mvcc_shard_stride + r;
      pass = p.xmin[o] <= p.snap && p.snap < p.xmax[o];
    }
    const long long off = plane + r;
    if (pass && p.pred_len)
      pass = run_program(p, p.pred_start, p.pred_len, off) != 0;
    int g = 0;
    if (pass && p.key_len) {
      const long long k = run_program(p, p.key_start, p.key_len, off);
      pass = k >= 0 && k < G;
      g = (int)k;
    }
    if (!__any_sync(0xffffffffu, pass)) continue;
    long long v[SA_MAX_VALUES];
#pragma unroll
    for (int e = 0; e < SA_MAX_VALUES; ++e) {
      v[e] = 0;
      if (e < E && pass)
        v[e] = run_program(p, p.val_start[e], p.val_len[e], off);
    }
    for (int gg = 0; gg < G; ++gg) {
      const bool mine = pass && g == gg;
      if (!__any_sync(0xffffffffu, mine)) continue;
#pragma unroll
      for (int e = 0; e < SA_MAX_VALUES; ++e) {
        if (e < E) {
          const long long tot = warp_sum(mine ? v[e] : 0);
          if (lane == 0) warp_acc[warp][gg * L + e] += (unsigned long long)tot;
        }
      }
      const unsigned cnt = __popc(__ballot_sync(0xffffffffu, mine));
      if (lane == 0) warp_acc[warp][gg * L + E] += cnt;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * L; i += SA_THREADS) {
    unsigned long long tot = 0;
#pragma unroll
    for (int w = 0; w < SA_WARPS; ++w) tot += warp_acc[w][i];
    if (tot == 0) continue;
    const int gg = i / L;
    const int e = i % L;
    if (e < E)
      atomicAdd(p.sums + ((long long)s * G + gg) * E + e, tot);
    else
      atomicAdd(p.counts + (long long)s * G + gg, tot);
  }
}

extern "C" int scan_agg_params_size() { return (int)sizeof(ScanAggParams); }

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): a refused launch never runs, and only this code
// reports it.
extern "C" int scan_agg_launch(const void* params, int blocks_per_shard,
                               int n_shards, void* stream) {
  const ScanAggParams* p = (const ScanAggParams*)params;
  dim3 grid(blocks_per_shard, n_shards);
  scan_agg_kernel<<<grid, SA_THREADS, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}
