// Spark HashPartitioning ids for one int32 / date key on Hopper:
//   out[i] = pmod(murmur3_x86_32(key[i], seed 42), num_partitions),
// where a null key hashes to the seed, 42.
//
// Replaces the TPU kernel spark_rapids_tpu/ops/pallas_kernels.py
// pallas_partition_ids_i32 (kernel body _make_kernel). That kernel walks a
// (cap/128, 128) view in 8x128 VMEM blocks and needs a capacity that is a
// multiple of 1024; both are TPU tiling, not part of the function, so
// these kernels take any length.
//
// Bound on an H100: bytes. A row reads a 4 B key and a 1 B validity byte
// and writes a 4 B id, 9 B in all: at 3.35 TB/s a 1,048,576-row batch
// needs 2.8 us. The vector kernel's work is about 40 SASS instructions per
// row (chip_smoke.py counts them), some 1.5 us for that batch at the
// card's issue rate: under the byte bound, but not by much, so the design
// keeps the batch's bytes in flight at once and spends little on a row:
//
// * The vector kernel gives each thread one 4-row chunk: its 16 B of keys
//   and its 4 B validity word are loaded together, before any arithmetic,
//   and its 4 ids leave in one 16 B store; neighbouring threads take
//   neighbouring chunks, so every warp-wide access is one contiguous
//   512 B or 128 B run. A 1,048,576-row batch is 1,024 blocks of 256
//   threads, one wave at full occupancy (8 blocks on each of 132 SMs):
//   all of its 5 MB of loads are issued in the first round trip. A first
//   design gave each thread 16 rows, all loads issued first: on an H100
//   it took 8.70 us by CUDA events and 4.71 us on the device at that
//   batch size, against 8.54 and 4.32 us for this one (chip_smoke.py,
//   PERF.md). The chunk index is 64-bit, so any length works. It needs
//   the key and output pointers 16 B aligned and the validity pointer
//   4 B aligned; the batches of the exchange's map side are (every
//   column of an upload starts at a 16 B offset).
// * The scalar kernel takes any alignment (a view at an odd row offset):
//   one row per thread in a grid-stride loop.
// * Neither divides: pmod uses Lemire's fastmod with a constant the host
//   computes once per call, magic = floor((2^64 - 1) / n) + 1 (mod 2^64),
//   so |h| mod n = mulhi64(magic * |h|, n), exact for every 32-bit |h|
//   and n in [1, 2^31 - 1]; a negative h with a non-zero remainder r
//   gives n - r (floor modulo, as Spark's pmod).
//
// At the exchange's batch size the kernel's time is mostly the fixed cost
// of a launch and one memory round trip, not the bytes (PERF.md).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The row function of both kernels: pmod(murmur3_x86_32(key, seed 42), n),
// a null key hashing to 42, pmod by fastmod (above).
__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ int32_t partition_id(uint32_t key, bool valid,
                                                uint32_t n, uint64_t magic) {
  // Murmur3_x86_32 hashInt: mixK1, mixH1 from seed 42, fmix(h1, 4)
  uint32_t k1 = key * 0xCC9E2D51u;
  k1 = rotl32(k1, 15) * 0x1B873593u;
  uint32_t h1 = rotl32(42u ^ k1, 13) * 5u + 0xE6546B64u;
  h1 ^= 4u;
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  h1 ^= h1 >> 16;
  const int32_t h = valid ? static_cast<int32_t>(h1) : 42;
  // fastmod: r = mulhi64(magic * |h|, n); n < 2^32, so the 128-bit high
  // word is (hi32(low) * n + ((lo32(low) * n) >> 32)) >> 32, exactly
  const uint32_t a = h < 0 ? 0u - static_cast<uint32_t>(h)
                           : static_cast<uint32_t>(h);
  const uint64_t low = magic * a;
  const uint64_t part = static_cast<uint64_t>(static_cast<uint32_t>(low)) * n;
  uint32_t r = static_cast<uint32_t>(((low >> 32) * n + (part >> 32)) >> 32);
  if (h < 0 && r != 0) r = n - r;
  return static_cast<int32_t>(r);
}

constexpr int kThreads = 256;
constexpr int kBlockRows = 4 * kThreads;   // one 4-row chunk a thread

__global__ void __launch_bounds__(kThreads)
partition_ids_i32_vector_kernel(const int4* __restrict__ keys,
                                const uint32_t* __restrict__ valid,
                                int4* __restrict__ out, int64_t rows,
                                uint32_t n, uint64_t magic) {
  const int64_t c =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t chunks = rows >> 2;
  const int tail = static_cast<int>(rows & 3);   // rows past the last chunk
  if (c > chunks || (c == chunks && tail == 0)) return;
  int4 k;
  uint32_t v;
  if (c < chunks) {
    k = keys[c];
    v = valid[c];
  } else {  // the one thread that takes the last 1-3 rows, one by one
    const int32_t* kt = reinterpret_cast<const int32_t*>(keys + c);
    const uint8_t* vt = reinterpret_cast<const uint8_t*>(valid + c);
    k = make_int4(kt[0], tail > 1 ? kt[1] : 0, tail > 2 ? kt[2] : 0, 0);
    v = vt[0] | (tail > 1 ? vt[1] << 8 : 0u) | (tail > 2 ? vt[2] << 16 : 0u);
  }
  int4 o;
  o.x = partition_id(k.x, (v & 0xFFu) != 0, n, magic);
  o.y = partition_id(k.y, (v & 0xFF00u) != 0, n, magic);
  o.z = partition_id(k.z, (v & 0xFF0000u) != 0, n, magic);
  o.w = partition_id(k.w, (v & 0xFF000000u) != 0, n, magic);
  if (c < chunks) {
    out[c] = o;
  } else {
    int32_t* ot = reinterpret_cast<int32_t*>(out + c);
    ot[0] = o.x;
    if (tail > 1) ot[1] = o.y;
    if (tail > 2) ot[2] = o.z;
  }
}

__global__ void __launch_bounds__(kThreads)
partition_ids_i32_scalar_kernel(const int32_t* __restrict__ keys,
                                const uint8_t* __restrict__ valid,
                                int32_t* __restrict__ out, int64_t rows,
                                uint32_t n, uint64_t magic) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
#pragma unroll 1
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < rows; i += stride) {
    out[i] = partition_id(static_cast<uint32_t>(keys[i]), valid[i] != 0, n,
                          magic);
  }
}

int multiprocessors() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0) {
      sms = 132;
    }
  }
  return sms;
}

// Launches `kernel` on `stream` of `device` (made current around the
// launch when it is not) and returns cudaGetLastError() (0 on success).
template <typename Launch>
int launch_on(int device, Launch&& kernel) {
  int current = -1;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  kernel();
  const int rc = static_cast<int>(cudaGetLastError());
  if (current != device) cudaSetDevice(current);
  return rc;
}

}  // namespace

// Each launcher runs on `stream` of `device` and returns 0 on success, else
// the CUDA error; rows == 0 launches nothing. The caller checks dtypes,
// lengths, 1 <= n <= 2^31 - 1, magic == floor((2^64 - 1) / n) + 1
// (mod 2^64) and, for the vector kernel, that keys and out are 16 B
// aligned and valid 4 B.
extern "C" int partition_ids_i32_vector_launch(const void* keys,
                                               const void* valid, void* out,
                                               int64_t rows, int n,
                                               uint64_t magic, int device,
                                               void* stream) {
  if (rows <= 0) return 0;
  const int64_t blocks = (rows + kBlockRows - 1) / kBlockRows;
  return launch_on(device, [&] {
    partition_ids_i32_vector_kernel<<<static_cast<unsigned>(blocks),
                                      kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(keys), static_cast<const uint32_t*>(valid),
        static_cast<int4*>(out), rows, static_cast<uint32_t>(n), magic);
  });
}

extern "C" int partition_ids_i32_scalar_launch(const void* keys,
                                               const void* valid, void* out,
                                               int64_t rows, int n,
                                               uint64_t magic, int device,
                                               void* stream) {
  if (rows <= 0) return 0;
  return launch_on(device, [&] {
    const int64_t want = (rows + kThreads - 1) / kThreads;
    const int64_t cap = static_cast<int64_t>(multiprocessors()) * 8;
    const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
    partition_ids_i32_scalar_kernel<<<blocks, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(keys), static_cast<const uint8_t*>(valid),
        static_cast<int32_t*>(out), rows, static_cast<uint32_t>(n), magic);
  });
}
