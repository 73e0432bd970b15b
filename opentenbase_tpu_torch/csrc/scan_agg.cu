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
// counted row (ops/scan_agg.py spec_bytes: about 20.6 bytes a row for
// TPC-H Q6, where 2 % of rows pass, and 36 for Q1). A row needs some tens
// of integer operations, below the card's ratio of operations to bytes,
// so the least time is those bytes over the 3.35 TB/s of HBM3. The
// design keeps enough bytes in flight for that rate and spends few
// instructions and little latency a row:
//
// - Staging. A block of 256 threads walks tiles of T = 256 x K rows (K
//   rows a thread: rows tid + k * 256) over a persistent grid. The
//   columns the predicate and key programs load, and full MVCC planes,
//   are copied tile by tile into shared memory by 1-D TMA bulk copies
//   (cp.async.bulk) that complete on a "full" mbarrier, n_stages (2-3)
//   tiles ahead of the tile being evaluated, so the next tiles' bytes
//   arrive while this one is computed. Thread 0 issues the copies as
//   soon as every warp has signalled the stage's "empty" mbarrier; no
//   other thread waits for it, and its walk ahead lives in shared
//   memory. Compact [S, 1] MVCC planes are not staged: they give a whole
//   shard one visibility test, made when its tiles are walked. The host
//   picks the instance and n_stages from the staged bytes a row
//   (ops/scan_agg.py launch_plan), so that two blocks share a
//   multiprocessor where they can and the widest spec still fits 227 KB.
// - Column-at-a-time bytecode. The host lowers the spec's programs to
//   one kernel program (ops/scan_agg.py kernel_code): a predicate
//   conjunct that compares a column with a constant is one filter word
//   that clears pass bits (in 32 bits where the column and constant
//   allow), a constant operand folds into its operator, x + 0 and x * 1
//   vanish. The host decodes each word into a record in the kernel's
//   parameter block (ops/scan_agg.py decode_program): its column's
//   stage offset or plane address, its constant. A word is dispatched
//   once per tile and runs as an unrolled loop over the thread's K rows. The dispatch is uniform over the block, so no
//   warp diverges. The host recorded each word's stack slot, so the
//   stack is a [depth][K] array of registers indexed by constants after
//   a branch on the slot: no stack pointer and a 0-byte stack frame.
//   Three instances cover the depths, (depth, K) = (4, 8), (8, 4),
//   (16, 2); a pass bit and a 4-bit group a row keep the rest small.
// - Value-only columns are gathered. A column that no predicate or key
//   program loads is read straight from device memory only for the rows
//   still passing, by K independent predicated loads a thread into the
//   stack registers; the value programs are laid out one above the other
//   on the stack ("stacked"), so all gathered loads of a tile are in
//   flight before the first is used. Q6's l_extendedprice is read for
//   its 2 %.
// - Accumulation once per block. One word counts a thread's passing rows
//   and adds all their values to their group's lanes in shared memory
//   (one add a lane when there is one group): per-thread lanes
//   (conflict-free, no atomics) while G x (E + 1) x 256 x 8 bytes fits
//   48 KB, else per-warp lanes with shared-memory atomics. The lanes are
//   reduced across the block only when the block leaves a shard (at most
//   once a shard) into one 64-bit atomicAdd per (shard, group, lane).
//   Integer addition keeps the result exact whatever order the blocks
//   run in.
//
// Built by nvcc into a shared library with a plain C interface
// (ops/cuda_build.py builds it, ops/scan_agg.py _load binds it);
// ScanAggParams is mirrored there by a ctypes.Structure whose size is
// checked against scan_agg_params_size().

#include <cstdint>
#include <cuda_runtime.h>

#define SA_MAX_COLS 16
#define SA_MAX_CODE 256
#define SA_MAX_VALUES 8
#define SA_MAX_KCODE (SA_MAX_CODE + SA_MAX_VALUES + 3)  // words a program
#define SA_THREADS 256  // a block; rows tid + k * SA_THREADS are a thread's
#define SA_MAX_STAGES 4
#define SA_HEAD 128  // bytes before the stages: their mbarriers, then
                     // thread 0's Producer
#define SA_PRODUCER (2 * SA_MAX_STAGES * 8)
#define SA_NARROW 4  // Ins.dtype flag: compare in 32 bits

// opcodes: ops/scan_agg.py OP_*
enum {
  OP_COL = 1, OP_CONST = 2, OP_ADD = 3, OP_SUB = 4, OP_MUL = 5, OP_NEG = 6,
  OP_EQ = 7, OP_NE = 8, OP_LT = 9, OP_LE = 10, OP_GT = 11, OP_GE = 12,
  OP_AND = 13, OP_OR = 14, OP_NOT = 15,
  // kernel only
  OP_PASS = 16, OP_KEY = 17, OP_COUNT = 18, OP_ACC = 19, OP_ANY = 20,
  OP_ACCN = 21,  // count, and add slots 0..arg-1 to lanes 0..arg-1
  OP_GCOL = 22,  // OP_COL of a gathered column
  OP_K = 32,     // OP_K + binop: slot = slot binop the word's constant
  OP_FILT = 64,  // OP_FILT + cmp: rows failing column cmp constant stop
};

// A word of the program, decoded by the host (ops/scan_agg.py
// decode_program): what running it needs, read from the parameter block.
struct Ins {
  int op;
  int slot;
  int off;      // OP_COL / OP_FILT: the column's stage offset
  int dtype;    // OP_COL / OP_GCOL / OP_FILT: the column's type (| SA_NARROW);
                // OP_ACC: the lane; OP_ACCN: the number of values
  long long v;  // the constant; a gathered column's plane address
};

struct ScanAggParams {
  const void* cols[SA_MAX_COLS];  // [S, rmax] planes, row-major
  const long long* xmin;          // [S, 1] or [S, rmax]
  const long long* xmax;
  const long long* nrows;         // [S]
  unsigned long long* sums;       // [S, G, E] int64
  unsigned long long* counts;     // [S, G] int64
  long long rmax;                 // row stride of the planes, a multiple of 16
  long long row_cap;              // rows at or past this are never real
  long long snap;
  int tiles_per_shard;
  int n_shards;
  int col_dtype[SA_MAX_COLS];     // 0 int32, 1 int64, 2 bool
  int col_smem[SA_MAX_COLS];      // byte offset in a stage; -1 gathered
  Ins prog[SA_MAX_KCODE];
  int code_len;
  int n_groups;
  int n_values;
  int xmin_smem, xmax_smem;       // stage offsets of full planes; -1 compact
  int stage_bytes;
  int n_stages;
  int acc_private;                // 1 per-thread lanes, 0 per-warp lanes
};

// ---------------------------------------------------------------------------
// TMA bulk copies and mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ int dtype_bytes(int dt) {
  return dt == 1 ? 8 : dt == 0 ? 4 : 1;
}

__device__ __forceinline__ uint32_t round16(long long n) {
  return (uint32_t)((n + 15) & ~15ll);
}

// ---------------------------------------------------------------------------
// The tile walk
// ---------------------------------------------------------------------------

// Rows of shard s the scan reaches: 0 when compact planes hide the shard.
__device__ __forceinline__ long long shard_rows(const ScanAggParams& p,
                                                int s) {
  if (p.xmin_smem < 0 && !(p.xmin[s] <= p.snap && p.snap < p.xmax[s]))
    return 0;
  const long long n = p.nrows[s];
  return n < p.row_cap ? n : p.row_cap;
}

// A tile: its flat index, its shard, its rows, the plane offset of its
// first row.
struct TileRef {
  int t;
  int shard;  // -1: the block has no tile left
  int rows;
  long long row0;
};

// The shard whose row count a walker last read, to read it once a shard.
struct ShardCache {
  int s = -1;
  long long n = 0;
};

// Thread 0's walk ahead of the block: the next tile to copy in.
struct Producer {
  TileRef ahead;
  ShardCache cache;
};
static_assert(SA_PRODUCER + sizeof(Producer) <= SA_HEAD,
              "the producer's walk must fit before the stages");

// The block's first tile at or after flat tile t (t = blockIdx.x mod
// gridDim.x) that holds rows (tests/test_torch_scan_agg.py mirrors the
// walk and checks that it covers every row once).
__device__ TileRef next_tile(const ScanAggParams& p, int t, int T,
                             ShardCache& c) {
  const int g = gridDim.x;
  while (t < p.n_shards * p.tiles_per_shard) {
    const int s = t / p.tiles_per_shard;
    if (s != c.s) {
      c.s = s;
      c.n = shard_rows(p, s);
    }
    const long long r0 = (long long)(t - s * p.tiles_per_shard) * T;
    if (r0 < c.n) {
      const long long left = c.n - r0;
      return {t, s, (int)(left < T ? left : T), s * p.rmax + r0};
    }
    const int nxt = (s + 1) * p.tiles_per_shard;
    t = nxt + ((int)blockIdx.x - nxt % g + g) % g;
  }
  return {t, -1, 0, 0};
}

// Copy a tile's staged columns (and full MVCC planes) into a stage. Each
// copy is the tile's rows rounded up to 16 bytes, which stays inside the
// plane: rmax and the tile's first row are multiples of 16 rows.
__device__ void issue_tile(const ScanAggParams& p, const TileRef& r,
                           unsigned char* stage, uint64_t* bar) {
  uint32_t tx = 0;
  for (int c = 0; c < SA_MAX_COLS; ++c)
    if (p.col_smem[c] >= 0)
      tx += round16((long long)r.rows * dtype_bytes(p.col_dtype[c]));
  if (p.xmin_smem >= 0) tx += 2 * round16((long long)r.rows * 8);
  mbar_expect_tx(bar, tx);
  for (int c = 0; c < SA_MAX_COLS; ++c) {
    if (p.col_smem[c] < 0) continue;
    const int w = dtype_bytes(p.col_dtype[c]);
    bulk_copy(stage + p.col_smem[c],
              (const unsigned char*)p.cols[c] + r.row0 * w,
              round16((long long)r.rows * w), bar);
  }
  if (p.xmin_smem >= 0) {
    bulk_copy(stage + p.xmin_smem, p.xmin + r.row0,
              round16((long long)r.rows * 8), bar);
    bulk_copy(stage + p.xmax_smem, p.xmax + r.row0,
              round16((long long)r.rows * 8), bar);
  }
}

// ---------------------------------------------------------------------------
// The interpreter: one word over the thread's K rows of a tile
// ---------------------------------------------------------------------------

struct Tile {
  const unsigned char* stage;  // the tile's staged bytes
  long long row0;              // plane offset of the tile's first row
  unsigned long long* acc;     // accumulator lanes
};

__device__ __forceinline__ void acc_add(const ScanAggParams& p,
                                        unsigned long long* acc, int g,
                                        int lane, long long v) {
  const int L = p.n_values + 1;
  const int i = g * L + lane;
  if (p.acc_private)
    acc[i * SA_THREADS + threadIdx.x] += (unsigned long long)v;
  else
    atomicAdd(acc + (threadIdx.x >> 5) * (p.n_groups * L) + i,
              (unsigned long long)v);
}

// A staged column's value for each of the thread's rows.
template <int K>
__device__ __forceinline__ void staged_col(const unsigned char* b, int dt,
                                           long long (&dst)[K]) {
  const int tid = threadIdx.x;
  if (dt == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      dst[k] = ((const int*)b)[tid + k * SA_THREADS];
  } else if (dt == 1) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      dst[k] = ((const long long*)b)[tid + k * SA_THREADS];
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) dst[k] = b[tid + k * SA_THREADS];
  }
}

// A gathered column: only the rows still passing read device memory,
// by K independent loads.
template <int K>
__device__ __forceinline__ void gathered_col(long long plane, int dt,
                                             long long row0, uint32_t pass,
                                             long long (&dst)[K]) {
  const long long o = row0 + threadIdx.x;
  // a predicated load into a zeroed register: nothing waits for it
  // until the value is used
#pragma unroll
  for (int k = 0; k < K; ++k) dst[k] = 0;
  if (dt == 0) {
    const int* g = (const int*)plane + o;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (pass >> k & 1u) dst[k] = __ldg(g + k * SA_THREADS);
  } else if (dt == 1) {
    const long long* g = (const long long*)plane + o;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (pass >> k & 1u) dst[k] = __ldg(g + k * SA_THREADS);
  } else {
    const unsigned char* g = (const unsigned char*)plane + o;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (pass >> k & 1u) dst[k] = __ldg(g + k * SA_THREADS);
  }
}

// Rows failing `x cmp c` stop passing.
template <int K, typename X, typename C>
__device__ __forceinline__ void filter_rows(int cmp, const X (&x)[K], C c,
                                            uint32_t& pass) {
  switch (cmp) {
#define SA_FILT(OPC, CMP)                           \
  case OPC:                                         \
    _Pragma("unroll") for (int k = 0; k < K; ++k)   \
      if (!(x[k] CMP c)) pass &= ~(1u << k);        \
    break;
    SA_FILT(OP_EQ, ==)
    SA_FILT(OP_NE, !=)
    SA_FILT(OP_LT, <)
    SA_FILT(OP_LE, <=)
    SA_FILT(OP_GT, >)
    SA_FILT(OP_GE, >=)
#undef SA_FILT
    default:
      break;
  }
}

// A conjunct: a staged column compared with a constant.
template <int K>
__device__ __forceinline__ void filter(const Ins& in, const Tile& t,
                                       uint32_t& pass) {
  const unsigned char* b = t.stage + in.off;
  const int tid = threadIdx.x;
  const int cmp = in.op - OP_FILT;
  if (in.dtype & SA_NARROW) {
    int x[K];
    if ((in.dtype & 3) == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        x[k] = ((const int*)b)[tid + k * SA_THREADS];
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) x[k] = b[tid + k * SA_THREADS];
    }
    filter_rows<K>(cmp, x, (int)in.v, pass);
  } else {
    long long x[K];
    staged_col<K>(b, in.dtype & 3, x);
    filter_rows<K>(cmp, x, in.v, pass);
  }
}

template <int K>
__device__ __forceinline__ void binop(int op, long long (&a)[K],
                                      const long long (&b)[K]) {
  switch (op) {
#define SA_BIN(OPC, EXPR)                           \
  case OPC:                                         \
    _Pragma("unroll") for (int k = 0; k < K; ++k) { \
      const long long x = a[k], y = b[k];           \
      a[k] = (EXPR);                                \
    }                                               \
    break;
    SA_BIN(OP_ADD, x + y)
    SA_BIN(OP_SUB, x - y)
    SA_BIN(OP_MUL, x * y)
    SA_BIN(OP_EQ, x == y)
    SA_BIN(OP_NE, x != y)
    SA_BIN(OP_LT, x < y)
    SA_BIN(OP_LE, x <= y)
    SA_BIN(OP_GT, x > y)
    SA_BIN(OP_GE, x >= y)
    SA_BIN(OP_AND, x & y)
    SA_BIN(OP_OR, x | y)
#undef SA_BIN
    default:
      break;
  }
}

// a op c for one constant c, over the K rows
template <int K>
__device__ __forceinline__ void binop_k(int op, long long (&a)[K],
                                        long long c) {
  switch (op) {
#define SA_BINK(OPC, EXPR)                          \
  case OPC:                                         \
    _Pragma("unroll") for (int k = 0; k < K; ++k) { \
      const long long x = a[k];                     \
      a[k] = (EXPR);                                \
    }                                               \
    break;
    SA_BINK(OP_ADD, x + c)
    SA_BINK(OP_SUB, x - c)
    SA_BINK(OP_MUL, x * c)
    SA_BINK(OP_EQ, x == c)
    SA_BINK(OP_NE, x != c)
    SA_BINK(OP_LT, x < c)
    SA_BINK(OP_LE, x <= c)
    SA_BINK(OP_GT, x > c)
    SA_BINK(OP_GE, x >= c)
    SA_BINK(OP_AND, x & c)
    SA_BINK(OP_OR, x | c)
#undef SA_BINK
    default:
      break;
  }
}

// Run BODY with the constant S equal to the runtime slot `slot` (< D):
// the stack is registers, so only a constant may index it.
#define SA_AT_SLOT(slot, ...)                                       \
  do {                                                              \
    SA_CASE(slot, 0, __VA_ARGS__) SA_CASE(slot, 1, __VA_ARGS__)     \
    SA_CASE(slot, 2, __VA_ARGS__) SA_CASE(slot, 3, __VA_ARGS__)     \
    SA_CASE(slot, 4, __VA_ARGS__) SA_CASE(slot, 5, __VA_ARGS__)     \
    SA_CASE(slot, 6, __VA_ARGS__) SA_CASE(slot, 7, __VA_ARGS__)     \
    SA_CASE(slot, 8, __VA_ARGS__) SA_CASE(slot, 9, __VA_ARGS__)     \
    SA_CASE(slot, 10, __VA_ARGS__) SA_CASE(slot, 11, __VA_ARGS__)   \
    SA_CASE(slot, 12, __VA_ARGS__) SA_CASE(slot, 13, __VA_ARGS__)   \
    SA_CASE(slot, 14, __VA_ARGS__) SA_CASE(slot, 15, __VA_ARGS__)   \
  } while (0)
#define SA_CASE(slot, N, ...)                  \
  if constexpr (N < D) {                       \
    if ((slot) == N) {                         \
      constexpr int S = N;                     \
      __VA_ARGS__                              \
    }                                          \
  }

// Evaluate one tile: visibility, then the program, over K rows a thread
// (row tid + k * threads of the tile). `pass` holds a bit a row (bit k:
// row k still passes), `grp` 4 bits a row (its group).
template <int D, int K>
__device__ __forceinline__ void run_tile(const ScanAggParams& p,
                                         const Tile& t, int rows) {
  const int tid = threadIdx.x;
  uint32_t pass = 0;
  uint32_t grp = 0;
  long long st[D][K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (tid + k * SA_THREADS < rows) pass |= 1u << k;
  if (p.xmin_smem >= 0) {
    const long long* xmn = (const long long*)(t.stage + p.xmin_smem);
    const long long* xmx = (const long long*)(t.stage + p.xmax_smem);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = tid + k * SA_THREADS;
      if (!(xmn[r] <= p.snap && p.snap < xmx[r])) pass &= ~(1u << k);
    }
  }
  const int n = p.code_len;
  const int L = p.n_values + 1;
  for (int i = 0; i < n; ++i) {
    const Ins& in = p.prog[i];  // uniform: one record for the whole block
    const int op = in.op;
    if (op >= OP_FILT) {
      filter<K>(in, t, pass);
    } else if (op >= OP_K) {
      SA_AT_SLOT(in.slot, binop_k<K>(op - OP_K, st[S], in.v););
    } else if (op == OP_COL) {
      SA_AT_SLOT(in.slot,
                 staged_col<K>(t.stage + in.off, in.dtype, st[S]););
    } else if (op == OP_GCOL) {
      SA_AT_SLOT(in.slot,
                 gathered_col<K>(in.v, in.dtype, t.row0, pass, st[S]););
    } else if (op == OP_CONST) {
      SA_AT_SLOT(in.slot, for (int k = 0; k < K; ++k) st[S][k] = in.v;);
    } else if (op == OP_ANY || op == OP_COUNT) {
      if (op == OP_COUNT) {
        if (p.n_groups == 1) {  // one group: one add of the thread's rows
          if (pass) acc_add(p, t.acc, 0, p.n_values, __popc(pass));
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (pass >> k & 1u)
              acc_add(p, t.acc, grp >> (4 * k) & 15u, p.n_values, 1);
        }
      }
      if (!__any_sync(0xffffffffu, pass != 0)) return;  // no row left
    } else if (op == OP_ACCN) {  // the count and values 0..E-1, stacked
      const int E = in.dtype;
      if (p.n_groups == 1) {
        if (pass) acc_add(p, t.acc, 0, p.n_values, __popc(pass));
#pragma unroll
        for (int e = 0; e < D; ++e) {
          if (e >= E) break;
          long long sum = 0;
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (pass >> k & 1u) sum += st[e][k];
          if (pass) acc_add(p, t.acc, 0, e, sum);
        }
      } else if (p.acc_private) {  // a row's lanes: one base address
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (!(pass >> k & 1u)) continue;
          unsigned long long* a =
              t.acc + (int)(grp >> (4 * k) & 15u) * L * SA_THREADS + tid;
          a[E * SA_THREADS] += 1ull;
#pragma unroll
          for (int e = 0; e < D; ++e) {
            if (e >= E) break;
            a[e * SA_THREADS] += (unsigned long long)st[e][k];
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (!(pass >> k & 1u)) continue;
          const int g = grp >> (4 * k) & 15u;
          acc_add(p, t.acc, g, E, 1);
#pragma unroll
          for (int e = 0; e < D; ++e) {
            if (e >= E) break;
            acc_add(p, t.acc, g, e, st[e][k]);
          }
        }
      }
    } else if (op == OP_PASS) {  // OP_PASS, OP_KEY, OP_ACC read slot 0
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (st[0][k] == 0) pass &= ~(1u << k);
    } else if (op == OP_KEY) {
      grp = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const long long g = st[0][k];
        if (g >= 0 && g < p.n_groups)
          grp |= (uint32_t)g << (4 * k);
        else
          pass &= ~(1u << k);
      }
    } else if (op == OP_ACC) {
      if (p.n_groups == 1) {
        long long sum = 0;
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (pass >> k & 1u) sum += st[0][k];
        if (pass) acc_add(p, t.acc, 0, in.dtype, sum);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (pass >> k & 1u)
            acc_add(p, t.acc, grp >> (4 * k) & 15u, in.dtype, st[0][k]);
      }
    } else if (op == OP_NEG) {
      SA_AT_SLOT(in.slot,
                 for (int k = 0; k < K; ++k) st[S][k] = -st[S][k];);
    } else if (op == OP_NOT) {
      SA_AT_SLOT(in.slot,
                 for (int k = 0; k < K; ++k) st[S][k] = 1 - st[S][k];);
    } else {  // binary: slots S and S + 1 -> slot S
      SA_AT_SLOT(in.slot, if constexpr (S + 1 < D)
                              binop<K>(op, st[S], st[S + 1]););
    }
  }
}
#undef SA_CASE
#undef SA_AT_SLOT

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Add the block's lanes for shard s to the outputs and zero them. Every
// thread calls it.
__device__ void flush(const ScanAggParams& p, unsigned long long* acc,
                      int s) {
  const int nt = SA_THREADS;
  const int nw = nt >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int L = p.n_values + 1;
  const int GL = p.n_groups * L;
  __syncthreads();
  for (int i = warp; i < GL; i += nw) {
    unsigned long long tot = 0;
    if (p.acc_private) {
      for (int j = lane; j < nt; j += 32) tot += acc[i * nt + j];
    } else {
      for (int w = lane; w < nw; w += 32) tot += acc[w * GL + i];
    }
    tot = warp_sum(tot);
    if (lane == 0 && tot) {
      const int g = i / L;
      const int e = i - g * L;
      if (e < p.n_values)
        atomicAdd(p.sums + ((long long)s * p.n_groups + g) * p.n_values + e,
                  tot);
      else
        atomicAdd(p.counts + (long long)s * p.n_groups + g, tot);
    }
  }
  __syncthreads();
  const int n = GL * (p.acc_private ? nt : nw);
  for (int i = threadIdx.x; i < n; i += nt) acc[i] = 0;
  __syncthreads();
}

// Shared memory: the stages' mbarriers and thread 0's Producer, the
// stages, the accumulator lanes. Stage i's "full"
// barrier completes when its tile's bytes have landed, its "empty"
// barrier when every warp is done with the tile. Thread 0 refills a
// stage as soon as it is empty; no other thread waits for it.
template <int D, int K>
__global__ void __launch_bounds__(SA_THREADS, 2)
scan_agg_kernel(const __grid_constant__ ScanAggParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = (uint64_t*)smem;
  uint64_t* empty = full + SA_MAX_STAGES;
  unsigned char* stages = smem + SA_HEAD;
  unsigned long long* acc =
      (unsigned long long*)(stages + (long long)p.n_stages * p.stage_bytes);
  const int nt = SA_THREADS;
  const int T = nt * K;
  const int NS = p.n_stages;
  const int L = p.n_values + 1;
  const int lanes = p.n_groups * L * (p.acc_private ? nt : nt >> 5);
  for (int i = threadIdx.x; i < lanes; i += nt) acc[i] = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], nt >> 5);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  ShardCache cc;
  TileRef cur = next_tile(p, blockIdx.x, T, cc);
  // thread 0 keeps NS tiles in flight ahead of the one evaluated; its
  // walk lives in shared memory, so no other thread holds it
  Producer& pr = *(Producer*)(smem + SA_PRODUCER);
  if (threadIdx.x == 0) {
    pr.ahead = cur;
    pr.cache = cc;
    for (int i = 0; i < NS && pr.ahead.shard >= 0; ++i) {
      issue_tile(p, pr.ahead, stages + i * p.stage_bytes, &full[i]);
      pr.ahead = next_tile(p, pr.ahead.t + gridDim.x, T, pr.cache);
    }
  }
  int shard = cur.shard;
  for (int it = 0; cur.shard >= 0; ++it) {
    const int sidx = it % NS;
    const uint32_t phase = (it / NS) & 1;
    unsigned char* stage = stages + sidx * p.stage_bytes;
    mbar_wait(&full[sidx], phase);
    run_tile<D, K>(p, Tile{stage, cur.row0, acc}, cur.rows);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[sidx]);
    if (threadIdx.x == 0 && pr.ahead.shard >= 0) {
      mbar_wait(&empty[sidx], phase);
      // the generic-proxy reads of the stage come before the bulk copy's
      // writes into it
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue_tile(p, pr.ahead, stage, &full[sidx]);
      pr.ahead = next_tile(p, pr.ahead.t + gridDim.x, T, pr.cache);
    }
    cur = next_tile(p, cur.t + gridDim.x, T, cc);
    if (cur.shard != shard) {  // uniform over the block
      flush(p, acc, shard);
      shard = cur.shard;
    }
  }
}

// A persistent grid: as many blocks as fit the card at once, at most
// `max_grid` (the tiles there are).
template <int D, int K>
static int launch(const ScanAggParams* p, int max_grid, int smem,
                  cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      scan_agg_kernel<D, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, scan_agg_kernel<D, K>, SA_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = max_grid < per_sm * sms ? max_grid : per_sm * sms;
  scan_agg_kernel<D, K><<<grid, SA_THREADS, smem, stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int scan_agg_params_size() { return (int)sizeof(ScanAggParams); }

// Launches the instance of stack depth `depth` and `rows` rows a thread
// on `stream` (PyTorch's current stream) and returns the CUDA error code:
// a refused launch never runs, and only this code reports it.
// `max_grid` >= 1.
extern "C" int scan_agg_launch(const void* params, int depth, int rows,
                               int max_grid, int smem, void* stream) {
  const ScanAggParams* p = (const ScanAggParams*)params;
  cudaStream_t st = (cudaStream_t)stream;
  if (depth == 4 && rows == 8) return launch<4, 8>(p, max_grid, smem, st);
  if (depth == 8 && rows == 4) return launch<8, 4>(p, max_grid, smem, st);
  if (depth == 16 && rows == 2) return launch<16, 2>(p, max_grid, smem, st);
  return (int)cudaErrorInvalidValue;
}
