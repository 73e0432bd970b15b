// Radix hash-join probe for Hopper (sm_90a): per probe row, find the first
// valid slot of its bucket whose key equals the probe key.
//
// Replaces the reference's Pallas kernel
// opentenbase_tpu/ops/pallas_join.py:build_probe (probe_radix_pallas).
// That kernel exists to get round Mosaic: keys split into six 12-bit f32
// limb planes, and a one-hot MXU dot stands in for the VMEM gather the
// TPU lacks, which caps it at P <= 4096 and B*6 <= 512. Hopper has int64
// compares and per-thread gathers, so none of that is carried over:
//
// - one thread per probe row (grid-stride loop). It reads the key at its
//   own width (int32 or int64), widens it in a register, and computes the
//   partition in the kernel: lo ^ (hi * 0x9E3779B1), then murmur3 fmix32,
//   then & (P - 1) — bit for bit utils/hashing.hash32_np;
// - it walks its bucket's slots in order: the valid slots are a prefix of
//   the bucket, sorted by key (ops/join.build_radix_table), so the first
//   valid slot with key >= the probe key is the lower bound. An invalid
//   slot or the bucket's end is a miss;
// - it writes matched and bidx for every row, 0 on a miss: the gather
//   that follows indexes by bidx, and an out-of-range index faults.
//
// Bound: bytes (ops/radix_probe.probe_bytes). Each row reads probe_real
// (1 B) and writes matched (1 B) and bidx (4 B); a real row also reads
// its key (4 or 8 B, counted in the 32-byte sectors that hold a real
// row); the table (13 B a slot, about 130 KB at the SSB shapes) is read
// from HBM once and then serves every bucket walk from L2. A few dozen
// integer operations a row sit far below the card's operations-to-bytes
// ratio.

#include <cuda_runtime.h>
#include <stdint.h>

#define RP_THREADS 256

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

template <typename K>
__global__ void __launch_bounds__(RP_THREADS) radix_probe_kernel(
    const int64_t* __restrict__ tkeys, const bool* __restrict__ tvalid,
    const int32_t* __restrict__ tbidx, const K* __restrict__ probe_key,
    const bool* __restrict__ probe_real, int64_t n, uint32_t pmask,
    int32_t bucket, bool* __restrict__ matched, int32_t* __restrict__ bidx) {
    const int64_t stride = (int64_t)gridDim.x * RP_THREADS;
    for (int64_t i = (int64_t)blockIdx.x * RP_THREADS + threadIdx.x; i < n;
         i += stride) {
        bool hit = false;
        int32_t row = 0;
        if (probe_real[i]) {  // a dead or NULL row reads no key
            const int64_t key = (int64_t)probe_key[i];
            const uint64_t u = (uint64_t)key;
            const uint32_t h =
                fmix32((uint32_t)u ^ ((uint32_t)(u >> 32) * 0x9E3779B1u));
            const int64_t base = (int64_t)(h & pmask) * bucket;
            for (int32_t r = 0; r < bucket; ++r) {
                const int64_t s = base + r;
                if (!tvalid[s]) break;
                const int64_t v = tkeys[s];
                if (v >= key) {
                    if (v == key) {
                        hit = true;
                        row = tbidx[s];
                    }
                    break;
                }
            }
        }
        matched[i] = hit;
        bidx[i] = row;
    }
}

extern "C" {

// key_is64: 1 for int64 probe keys, 0 for int32. Returns the CUDA error
// code of the launch (0 on success).
int radix_probe_launch(const void* tkeys, const void* tvalid,
                       const void* tbidx, const void* probe_key,
                       int key_is64, const void* probe_real, int64_t n,
                       int partitions, int bucket, void* matched, void* bidx,
                       int blocks, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const uint32_t pmask = (uint32_t)partitions - 1u;
    if (key_is64) {
        radix_probe_kernel<int64_t><<<blocks, RP_THREADS, 0, st>>>(
            (const int64_t*)tkeys, (const bool*)tvalid, (const int32_t*)tbidx,
            (const int64_t*)probe_key, (const bool*)probe_real, n, pmask,
            bucket, (bool*)matched, (int32_t*)bidx);
    } else {
        radix_probe_kernel<int32_t><<<blocks, RP_THREADS, 0, st>>>(
            (const int64_t*)tkeys, (const bool*)tvalid, (const int32_t*)tbidx,
            (const int32_t*)probe_key, (const bool*)probe_real, n, pmask,
            bucket, (bool*)matched, (int32_t*)bidx);
    }
    return (int)cudaGetLastError();
}

int radix_probe_threads(void) { return RP_THREADS; }

}  // extern "C"
