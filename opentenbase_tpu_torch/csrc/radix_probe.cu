// Radix hash-join probe for Hopper (sm_90a): per probe row, find the first
// valid slot of its bucket whose key equals the probe key.
//
// Replaces the reference's Pallas kernel
// opentenbase_tpu/ops/pallas_join.py:build_probe (probe_radix_pallas).
// That kernel exists to get round Mosaic: keys split into six 12-bit f32
// limb planes, and a one-hot MXU dot stands in for the VMEM gather the
// TPU lacks, which caps it at P <= 4096 and B*6 <= 512. Hopper has int64
// compares and per-thread gathers, so none of that is carried over.
//
// What bounds it: bytes (ops/radix_probe.probe_bytes). Each row reads
// probe_real (1 B) and writes matched (1 B) and bidx (4 B); a real row
// also reads its key (4 or 8 B, counted in the 32-byte sectors that hold
// a real row); the table (13 B a slot, about 130 KB at the SSB shapes) is
// read once and then serves every bucket walk from L1/L2. A few dozen integer operations a real row sit far below the
// card's operations-to-bytes ratio. The design moves those bytes in wide,
// coalesced accesses and spends its instructions on real rows only:
//
// - 16 rows a thread, 512 a warp. A thread reads its rows' probe_real as
//   one 16-byte load, issued one chunk ahead of the chunk being worked.
// - Compaction. The warp packs the offsets of its real rows (8-13 % of
//   SSB's rows) into a queue in shared memory, in row order, with a
//   prefix sum over the lanes. Each lane then takes up to RP_U queued
//   rows at once: it issues all their key loads, computes their
//   partitions, and walks their buckets together, one slot a step. A
//   dead row costs no key load, no hash and no walk.
// - The walk: the partition is lo ^ (hi * 0x9E3779B1), murmur3 fmix32,
//   & (P - 1), bit for bit utils/hashing.hash32_np on the key widened to
//   int64. The valid slots are a prefix of the bucket, sorted by key
//   (ops/join.build_radix_table), so the first valid slot with key >= the
//   probe key is the lower bound; an invalid slot or the bucket's end is
//   a miss.
// - Results land in the warp's shared-memory rows (zeroed first: a miss
//   writes 0, the gather that follows indexes by bidx and an
//   out-of-range index faults), and leave as 16-byte stores that cover
//   the warp's 512 B of matched and 2 KB of bidx contiguously.
// - A chunk that runs past n, or probe arrays whose base is not 16-byte
//   aligned (the wrapper says which), take per-row loads and stores.
// - The table is read through L1/L2: copying it into each block's shared
//   memory first measured slower on SSB's shapes (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#define RP_ROWS 16                  // rows a thread
#define RP_CHUNK (32 * RP_ROWS)      // rows a warp
#define RP_U 4                       // queued rows a lane walks at once
#define RP_WARP_SMEM (RP_CHUNK * 2 + RP_CHUNK * 4 + RP_CHUNK)  // 3.5 KB

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The 16-bit mask of a thread's real rows from its 16 probe_real bytes.
__device__ __forceinline__ uint32_t real_mask(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      m |= (uint32_t)(((w[q] >> (8 * b)) & 0xffu) != 0u) << (4 * q + b);
  return m;
}

#define RP_THREADS 256

template <typename KT>
__global__ void __launch_bounds__(RP_THREADS)
radix_probe_kernel(const int64_t* __restrict__ tkeys,
                   const bool* __restrict__ tvalid,
                   const int32_t* __restrict__ tbidx,
                   const KT* __restrict__ probe_key,
                   const bool* __restrict__ probe_real, int64_t n,
                   uint32_t pmask, int32_t bucket, int vec,
                   bool* __restrict__ matched, int32_t* __restrict__ bidx) {
  extern __shared__ __align__(16) unsigned char sm[];
  const unsigned char* valid = (const unsigned char*)tvalid;
  const int lane = threadIdx.x & 31;
  unsigned char* ws = sm + (threadIdx.x >> 5) * RP_WARP_SMEM;
  int32_t* rb = (int32_t*)ws;                                // bidx
  uint16_t* queue = (uint16_t*)(ws + RP_CHUNK * 4);          // real rows
  unsigned char* rm = ws + RP_CHUNK * 6;                     // matched

  const int64_t chunks = (n + RP_CHUNK - 1) / RP_CHUNK;
  const int64_t stride = (int64_t)gridDim.x * (blockDim.x >> 5);
  int64_t c = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  uint4 ahead = make_uint4(0, 0, 0, 0);  // the next chunk's flags
  if (vec && c < chunks && (c + 1) * RP_CHUNK <= n)
    ahead = __ldg((const uint4*)(probe_real + c * RP_CHUNK) + lane);
  for (; c < chunks; c += stride) {  // uniform over the warp
    const int64_t w0 = c * RP_CHUNK;
    const int64_t r0 = w0 + lane * RP_ROWS;
    const bool whole = vec && w0 + RP_CHUNK <= n;
    uint32_t live = 0;
    if (whole) {
      live = real_mask(ahead);
      const int64_t nx = c + stride;
      if (nx < chunks && (nx + 1) * RP_CHUNK <= n)
        ahead = __ldg((const uint4*)(probe_real + nx * RP_CHUNK) + lane);
    } else {
#pragma unroll
      for (int i = 0; i < RP_ROWS; ++i)
        if (r0 + i < n && probe_real[r0 + i]) live |= 1u << i;
    }
    // zero this thread's result rows; queue its real rows after those
    // of the lanes below it
    *(uint4*)(rm + lane * RP_ROWS) = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      ((int4*)rb)[lane * 4 + q] = make_int4(0, 0, 0, 0);
    const int cnt = __popc(live);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    int off = incl - cnt;
    for (uint32_t m = live; m; m &= m - 1)
      queue[off++] = (uint16_t)(lane * RP_ROWS + __ffs(m) - 1);
    __syncwarp();

    for (int j0 = 0; j0 < total; j0 += 32 * RP_U) {
      int at[RP_U];
      int64_t key[RP_U];
      int32_t base[RP_U];
#pragma unroll
      for (int u = 0; u < RP_U; ++u) {  // every key load first
        const int j = j0 + u * 32 + lane;
        at[u] = j < total ? (int)queue[j] : -1;
        key[u] = at[u] >= 0 ? (int64_t)probe_key[w0 + at[u]] : 0;
      }
#pragma unroll
      for (int u = 0; u < RP_U; ++u) {
        const uint64_t x = (uint64_t)key[u];
        const uint32_t h =
            fmix32((uint32_t)x ^ ((uint32_t)(x >> 32) * 0x9E3779B1u));
        base[u] = (int32_t)(h & pmask) * bucket;
      }
      uint32_t active = 0;
#pragma unroll
      for (int u = 0; u < RP_U; ++u) active |= (uint32_t)(at[u] >= 0) << u;
      for (int32_t r = 0; r < bucket && active; ++r) {
#pragma unroll
        for (int u = 0; u < RP_U; ++u) {
          if (!((active >> u) & 1u)) continue;
          const int32_t s = base[u] + r;
          const bool ok = valid[s];
          const int64_t v = tkeys[s];
          if (!ok || v >= key[u]) {
            active &= ~(1u << u);
            if (ok && v == key[u]) {
              rm[at[u]] = 1;
              rb[at[u]] = tbidx[s];
            }
          }
        }
      }
    }
    __syncwarp();
    if (whole) {  // the warp's rows leave as contiguous 16-byte stores
      ((uint4*)(matched + w0))[lane] = ((const uint4*)rm)[lane];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ((int4*)(bidx + w0))[q * 32 + lane] =
            ((const int4*)rb)[q * 32 + lane];
    } else {
#pragma unroll
      for (int i = 0; i < RP_ROWS; ++i) {
        if (r0 + i < n) {
          matched[r0 + i] = rm[lane * RP_ROWS + i];
          bidx[r0 + i] = rb[lane * RP_ROWS + i];
        }
      }
    }
    __syncwarp();  // the buffers are refilled by the next chunk
  }
}

template <typename KT>
static int launch(const void* tkeys, const void* tvalid, const void* tbidx,
                  const void* probe_key, const void* probe_real, int64_t n,
                  uint32_t pmask, int32_t bucket, int vec, void* matched,
                  void* bidx, cudaStream_t st) {
  auto kern = radix_probe_kernel<KT>;
  const int smem = (RP_THREADS / 32) * RP_WARP_SMEM;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                    RP_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t chunks = (n + RP_CHUNK - 1) / RP_CHUNK;
  const int64_t need = (chunks + RP_THREADS / 32 - 1) / (RP_THREADS / 32);
  const int grid = (int)(need < (int64_t)per_sm * sms ? need
                                                      : (int64_t)per_sm * sms);
  kern<<<grid, RP_THREADS, smem, st>>>(
      (const int64_t*)tkeys, (const bool*)tvalid, (const int32_t*)tbidx,
      (const KT*)probe_key, (const bool*)probe_real, n, pmask, bucket, vec,
      (bool*)matched, (int32_t*)bidx);
  return (int)cudaGetLastError();
}

extern "C" {

// key_is64: 1 for int64 probe keys, 0 for int32. vec: 1 when probe_key,
// probe_real, matched and bidx all start on 16-byte boundaries. A
// persistent grid of as many blocks as fit the card at once. Returns the
// CUDA error code of the launch (0 on success).
int radix_probe_launch(const void* tkeys, const void* tvalid,
                       const void* tbidx, const void* probe_key,
                       int key_is64, const void* probe_real, int64_t n,
                       int partitions, int bucket, int vec, void* matched,
                       void* bidx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t pmask = (uint32_t)partitions - 1u;
  if (key_is64)
    return launch<int64_t>(tkeys, tvalid, tbidx, probe_key, probe_real, n,
                           pmask, bucket, vec, matched, bidx, st);
  return launch<int32_t>(tkeys, tvalid, tbidx, probe_key, probe_real, n,
                         pmask, bucket, vec, matched, bidx, st);
}

}  // extern "C"
