// Stage D: the pair list sorted by its packed key (ops/sorting.py).
//
// The reference sorts (key, splat-index) pairs with cub::DeviceRadixSort
// (sortTileList, GaussianRender.cu:804-855); the JAX package leaves its
// variadic sort to XLA's lax.sort, so there is no TPU kernel to port.
//
// The packed key is one uint32 word (tile << 19 | depth19; sentinels
// 0xFFFFFFFF), carried in an int32 tensor.  gsr_sort_words sorts it with
// the words that travel with it (the 3 attribute words, and the splat
// index where asked; the measurement harness sorts 1-3 words) in three
// launches:
//
//   1. gsr_sort_slots_index_elementwise_kernel writes each slot's index
//      0..n-1, the sort's payload, and packs the slot's words into one
//      16-B record.  Bytes: 12 B read, 20 B written a slot.
//   2. cub::DeviceRadixSort::SortPairs<uint32_t, int32_t> sorts the key as
//      the uint32 it is, over bits [0, 32), with the slot index as its
//      payload: 4 onesweep passes of 8 bits, each reading and writing 4 B
//      of key and 4 B of payload (64 B a slot), where torch.sort of the key
//      widened to int64 with int64 indices made 8 passes of 16 B.  Its LSD
//      passes are stable: equal keys keep their slot order.  One template
//      instance, so that the build stays short.
//   3. gsr_sort_index_elementwise_kernel reads each sorted slot index once,
//      loads that slot's record and writes its words into the [words, n]
//      output.  Bytes: 4 B index, 16 B record, 12 B written (3 words).
//
// Why the records: the sorted slot order is close to random over the emit
// order (emission is splat-major, the sort tile-major), and a gathered word
// costs a 32-B sector wherever the cache misses.  Gathered from the three
// words' own rows, a slot costs three sectors; gathered as one record, one.
// At the mip360 cell (~10 M slots, H100) the record pass took 0.111 ms with
// the slot indices and the record gather 0.196, against 0.097 for
// torch.arange's slot indices and 0.404 for the best row gather (a word a
// pass, so that the word's 40-MB row stays in the 50-MB L2; 0.562 with the
// three rows in one pass; torch's three int64-index gathers 0.367).  The
// record pass takes kRecordSlots slots a thread, kThreads apart, so that a
// warp's loads and stores of a row are 128 contiguous bytes (4 a thread
// 0.112 ms, 8 0.115); the gather one slot a thread (2 0.201 ms, 4 0.216, 8
// 0.230: a thread's record loads in flight did not pay), its stores
// streaming past the cache (__stcs).
//
// Both hand-written kernels keep "index_elementwise_kernel" in their
// names, as the torch gathers they replace are named, so that a trace
// counts them with the sort as stage D's work.
#include "common.cuh"

#include <climits>
#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kRecordSlots = 2;  // slots a thread of the record pass
constexpr int kRecordTile = kThreads * kRecordSlots;
constexpr int kMaxWords = 4;

struct WordsArgs {
  const uint32_t* src[kMaxWords];  // the words by slot, null past `words`
  int words;
  long long n;
};

__device__ __forceinline__ uint32_t word_at(const WordsArgs& a, int w, long long i) {
  return w < a.words ? a.src[w][i] : 0u;
}

// slots[i] = i; records[i] = the slot's words, zero past `words`.
__global__ void __launch_bounds__(kThreads)
    gsr_sort_slots_index_elementwise_kernel(WordsArgs a, int* __restrict__ slots,
                                            uint4* __restrict__ records) {
  const long long base = static_cast<long long>(blockIdx.x) * kRecordTile + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kRecordSlots; ++k) {
    const long long i = base + k * kThreads;
    if (i < a.n) {
      slots[i] = static_cast<int>(i);
      if (a.words > 0)
        records[i] = make_uint4(word_at(a, 0, i), word_at(a, 1, i), word_at(a, 2, i),
                                word_at(a, 3, i));
    }
  }
}

// out[w * n + i] = word w of records[perm[i]].
__global__ void __launch_bounds__(kThreads)
    gsr_sort_index_elementwise_kernel(const int* __restrict__ perm,
                                      const uint4* __restrict__ records, int words, long long n,
                                      uint32_t* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4 r = records[perm[i]];
  const uint32_t v[kMaxWords] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w)
    if (w < words) __stcs(out + w * n + i, v[w]);
}

cudaError_t radix_sort(void* temp, size_t& temp_bytes, const void* keys_in, void* keys_out,
                       const int* slots_in, int* slots_out, long long n, cudaStream_t s) {
  return cub::DeviceRadixSort::SortPairs(
      temp, temp_bytes, static_cast<const uint32_t*>(keys_in), static_cast<uint32_t*>(keys_out),
      slots_in, slots_out, static_cast<int>(n), 0, 32, s);
}

}  // namespace

// cub's temporary storage for sorting n pairs, in *bytes.  Runs nothing on
// the device.
GSR_EXPORT int gsr_sort_temp_bytes(long long n, size_t* bytes) {
  if (n < 0 || n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  *bytes = 0;
  return static_cast<int>(radix_sort(nullptr, *bytes, nullptr, nullptr, nullptr, nullptr, n,
                                     nullptr));
}

// keys_in, keys_out: [n] uint32; src0..src3: [>= n] int32 words by slot (the
// first `words`, 0-4, of them are read); out: [words, n] int32.  Scratch:
// slots and perm [n] int32, records [n] 16-B (unused without words),
// temp: gsr_sort_temp_bytes(n) bytes.  keys_out holds the keys ascending,
// equal keys in slot order, and row w of out each one's word w.
GSR_EXPORT int gsr_sort_words(const void* keys_in, const void* src0, const void* src1,
                              const void* src2, const void* src3, int words, long long n,
                              void* keys_out, void* out, void* slots, void* perm, void* records,
                              void* temp, long long temp_bytes, void* stream) {
  if (n < 0 || n > INT_MAX || words < 0 || words > kMaxWords || temp == nullptr ||
      temp_bytes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  WordsArgs a;
  const void* src[kMaxWords] = {src0, src1, src2, src3};
  for (int w = 0; w < kMaxWords; ++w)
    a.src[w] = w < words ? static_cast<const uint32_t*>(src[w]) : nullptr;
  a.words = words;
  a.n = n;
  gsr_sort_slots_index_elementwise_kernel<<<gsr::blocks_for(n, kRecordTile), kThreads, 0, s>>>(
      a, static_cast<int*>(slots), static_cast<uint4*>(records));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t bytes = static_cast<size_t>(temp_bytes);
  err = radix_sort(temp, bytes, keys_in, keys_out, static_cast<const int*>(slots),
                   static_cast<int*>(perm), n, s);
  if (err != cudaSuccess || words == 0) return static_cast<int>(err);
  gsr_sort_index_elementwise_kernel<<<gsr::blocks_for(n, kThreads), kThreads, 0, s>>>(
      static_cast<const int*>(perm), static_cast<const uint4*>(records), words, n,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
