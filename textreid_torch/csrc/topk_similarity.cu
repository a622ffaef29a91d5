// topk_similarity_f32 (K2) and topk_similarity_int8 (K4): streaming top-k
// of queries @ gallery^T without materialising the [Q, G] score matrix, in
// one launch.
//
// Replaces: textreid_tpu/ops/ranking_pallas.py:211 topk_similarity (Pallas
// kernel from _make_kernel, merge _fold_tile :41), f32, and its
// compute_dtype=bfloat16 option; and :372 topk_similarity_quantized (kernel
// from _make_quant_kernel).  Contract (ops/ranking.py: the plain versions):
//   vals[q, :], idx[q, :] = the k best (score, row) pairs of row q over
//   gallery rows < valid_gallery, sorted under (score desc, row desc): on an
//   exact tie the larger row wins.  Slots past the number of valid rows hold
//   NEG_INF (-3e38) and row -1.
//   K2:      score = sum_d Q[q, d] G[g, d], f32 products summed in f32 on
//            the FP32 cores (no TF32); with round_bf16 both operands are
//            rounded to bf16 first (the products are exact in f32).
//   K4:      score = (sum_d float(bf16(Q[q, d])) * float(G[g, d])) * scales[g]
//            (ops/quant.py:quantized_scores): bf16 x int8 is exact in f32,
//            so only the order of the f32 sum differs from a matmul's.
// Q [Q, D] f32, G [G, D] f32 (D % 4 == 0) or int8 (D % 16 == 0), scales [G]
// f32, 1 <= k <= 64, D <= 768, any Q >= 1.
//
// What bounds them on the H100 (D = 256, k = 10; chip_smoke.py:
// topk_bound).  At one query, bytes: the gallery read once, 1 KB a row in
// f32 (0.030 ms at G = 98,304 at 3.35 TB/s), a quarter of that in int8
// (0.0076 ms); at G = 3,074 a few microseconds of launch, ring fill and the
// merge of the splits' lists set the floor.  At 256 queries, operations:
// 2 Q G D, 0.19 ms at G = 98,304 on the FP32 cores (67 TFLOP/s), 0.013 ms
// for K4 at the bf16 tensor-core rate; and beside them the selection of the
// top-k, which no roofline counts.
//
// Design.
// * One plan, chosen by Q (make_plan, mirrored by ops/ranking.py:
//   topk_plan): a grid of (query tiles of QT = 8-64 queries, gallery
//   splits), one block an SM, one wave: one 8-query tile over 132 splits at
//   Q <= 8 (every SM streams); at Q = 256 over a large gallery tiles of 64
//   queries for K2 (the gallery streamed 4 times, not 32) and 32 for K4
//   (whose products are cheap beside the last block's merge of a tile's
//   lists); smaller tiles where splits of fewer than 256 rows would leave
//   the running top-k, not the products, as a block's work.
// * A block is 8 consumer warps and one producer warp.  The producer's one
//   thread keeps a ring of 3-6 stages in flight, each stage a 256-byte
//   chunk of D of 128 consecutive gallery rows: two TMA boxes of [128 rows,
//   128 bytes] in the 128-byte swizzle, on one mbarrier (the gallery's
//   tensor map is made once per gallery address); the consumer warps
//   release a stage on a second mbarrier.  The swizzle puts eight
//   consecutive rows' 16-byte pieces at one offset in eight distinct bank
//   groups, so no read below has a bank conflict but the bf16 path's
//   (two-way).  Rows past the gallery arrive as zeros; a tile's rows of the
//   next split are loaded and never ranked.  The block stages its query
//   tile once: f32 for the FP32 path, rounded to bf16 and zero-padded to a
//   multiple of 32 in D for the tensor-core paths.  (One cp.async.bulk a
//   row, the first design, ran at ~60 ns a copy an SM, far below the
//   bytes: chip_smoke.py's K2 at Q = 1, G = 98,304 took 0.119 ms.)
// * K2 in f32: register tiles on the FP32 cores.  A warp owns TR rows a
//   lane (32 TR rows) and TQ queries, TR x TQ = 1 x 4 to 4 x 8 (64-query
//   tiles: a warp every row of the tile for 8 queries); a step over 4 of D
//   is TR 16-byte row loads and TQ broadcast 16-byte query loads for
//   4 TR TQ FMAs.  The sums run over D in order, as the old kernel's.
// * K4, and K2 with round_bf16: mma.sync.m16n8k16 bf16 -> f32, the gallery
//   rows as A, converted in registers (int8 -> bf16 exactly by a byte
//   permute under 2^23; f32 -> bf16 rounded to nearest, as the old kernel's
//   staging did), the query tile as B, 8 queries an n-tile, so one query
//   costs one n-tile.  A warp owns 16 rows and every query of the tile (a
//   row is converted once).  K4 multiplies the row's scale on the f32 sum.
//   mma.sync, not wgmma: A has to pass through registers for the
//   conversion anyway, one query needs an 8-wide tile, and the products
//   take well under half of K4's time at every shape (the selection takes
//   most).
// * Selection: each score is compared with its query's current k-th entry,
//   in (value, row) order (ranks_above), kept in shared memory; only the
//   survivors go, one atomic each, to the query's buffer of 64 candidates.
//   Buffers are folded into their queries' sorted lists (64 entries) only
//   when one fills (then every buffer at least half full is folded, and
//   the scores turned away try again against the raised thresholds) and
//   after the last tile: a fold sorts the candidates by a warp's bitonic
//   network and merges them with the list (the larger of list[p] and
//   candidate[63 - p], then a bitonic merge).  A tile with no overflow
//   costs one barrier.
// * One launch: each block writes its sorted lists to scratch ([Q, splits,
//   k rounded up to 4]); the last block of a query tile to finish (a ticket
//   counter a query tile, after __threadfence) merges the tile's lists: it
//   copies them into the ring, and a warp merges a query's lists by
//   tournament (k rounds; each takes the best head of the lists, a
//   shuffle reduction over the lanes that hold them).  The wrapper keeps
//   the counters, zeroed, one set a device; the last block resets its
//   counter to 0.  Two launches that run at once on two streams must not
//   share the counters (serving uses one stream).
//
// What was hard, and what the design does about it (clock64 breakdowns of
// block 0, NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).  The first working
// version spent ~85% of K4's time at Q = 256, G = 98,304 outside the
// products: per-row bulk copies, then the selection.  A fold by rank
// counting (each entry scanning list + candidates) and a fold after every
// tile cost ~1 us each and ran for every query nearly every tile; folding
// only when a buffer fills, by a bitonic network, and appending with one
// atomic a survivor (not a ballot, an atomic and a shuffle a score slot)
// took K4 there from 0.42 to 0.23 ms, and 32-query tiles for the
// tensor-core paths (the last block's merge of a tile's lists is the tail)
// to 0.21.  Tried and dropped: merging the splits' lists through a lower
// bound of the k-th score (as the first version did) and a fold of the
// entries above it (slower than the tournament at k = 10, ~8x at k = 64);
// two tournaments a warp interleaved (slower); skipping the FP32 products
// of padding queries query by query (it broke the unrolled loop: 0.52 ->
// 0.69 ms); unrolling the FP32 loop by 1 or 4 instead of 2 (no change).
// The FP32 products run at ~60% of the FMA rate at Q = 256 (two warps a
// scheduler; shared memory serves 24 wavefronts a step beside 128 FMAs).

#include <cuda.h>  // CUtensorMap and its enums; no -lcuda: the encoder is
                   // reached through the runtime's driver entry point
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr float kNegInf = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileRows = 128;      // gallery rows a stage holds
constexpr int kChunkBytes = 256;    // bytes of a row a stage holds
constexpr int kBoxBytes = 128;      // bytes of a row a TMA box holds
constexpr int kBoxes = kChunkBytes / kBoxBytes;
constexpr int kStageBytes = kTileRows * kChunkBytes;
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kKMax = 64;
constexpr int kMinStages = 3;
constexpr int kMaxStages = 6;
constexpr int kSmemMax = 232448;
constexpr int kSplitsMax = 192;  // the lists of a query fit 3 stages
constexpr int kQTiles[4] = {64, 32, 16, 8};

enum Kind { kF32 = 0, kBf16 = 1, kInt8 = 2 };

__host__ __device__ constexpr int elem_bytes(int kind) {
  return kind == kInt8 ? 1 : 4;
}
__host__ __device__ constexpr int chunk_elems(int kind) {
  return kChunkBytes / elem_bytes(kind);
}
// candidates a query holds between folds (a warp's bitonic merge is 64
// wide)
constexpr int kCandCap = 64;
// bytes of a staged query row: f32 as it is; bf16 zero-padded to a multiple
// of 32 elements, the stride 32 bytes past a multiple of 128 (the 8-byte
// fragment reads of 8 queries x 4 threads fall in distinct banks)
__host__ __device__ inline int query_stride(int kind, int dim) {
  if (kind == kF32) return dim * 4;
  const int padded = ((dim + 31) / 32) * 64;
  return ((padded + 127) / 128) * 128 + 32;
}

struct Entry {
  float v;
  int i;
};

// Byte offsets of a block's shared memory (mirrored by ops/ranking.py:
// _shared_bytes), from a base aligned to 1,024 bytes (the swizzle's atom;
// the layout's total counts 1 KB of slack for that).
struct Layout {
  int ring, queries, lists, cands, thr, cnt, nl, bars, misc, total;
};

__host__ __device__ inline Layout layout(int kind, int qt, int dim,
                                         int stages) {
  Layout l;
  int off = 0;
  l.ring = off;
  off += stages * kStageBytes;
  l.queries = off;
  off += qt * query_stride(kind, dim);
  l.lists = off;
  off += qt * kKMax * 8;
  l.cands = off;
  off += qt * kCandCap * 8;
  l.thr = off;
  off += qt * 8;
  l.cnt = off;
  off += qt * 4;
  l.nl = off;
  off += qt * 4;
  l.bars = off;
  off += 2 * stages * 8;
  l.misc = off;
  off += 16;
  l.total = off + 1024;
  return l;
}

int fit_stages(int kind, int qt, int dim) {
  for (int s = kMaxStages; s >= kMinStages; --s) {
    if (layout(kind, qt, dim, s).total <= kSmemMax) return s;
  }
  return 0;
}

struct Plan {
  int qt, splits, stages, smem;
};

// The launch plan (mirrored by ops/ranking.py:topk_plan): the largest query
// tile (<= the next power of two of Q, >= 8; <= 32 but for the FP32 path
// at Q >= 256) that fits with 3 stages and whose grid fills three quarters
// of the SMs with splits of at least 256 rows (16 at an 8-query tile); else
// the one with the most blocks.  Split s holds rows [s n / splits, (s + 1)
// n / splits).  (The last block of a query tile merges all its queries'
// lists: 64-query tiles paid that tail for the tensor-core paths at every
// Q and for the FP32 path below 256 queries.)
Plan make_plan(int kind, int n_q, int n_rows, int dim, int sms) {
  const int top = kind == kF32 && n_q >= 256 ? 64 : 32;
  int cap = 8;
  while (cap < n_q && cap < top) cap *= 2;
  Plan best = {0, 0, 0, 0};
  long best_blocks = -1;
  for (int qt : kQTiles) {
    if (qt > cap) continue;
    const int stages = fit_stages(kind, qt, dim);
    if (!stages) continue;
    const int q_tiles = (n_q + qt - 1) / qt;
    const int min_rows = qt == 8 ? 16 : 256;
    int splits = sms / q_tiles;
    if (splits > kSplitsMax) splits = kSplitsMax;
    const int by_rows = (n_rows + min_rows - 1) / min_rows;
    if (splits > by_rows) splits = by_rows;
    if (splits < 1) splits = 1;
    const long blocks = static_cast<long>(q_tiles) * splits;
    const Plan p = {qt, splits, stages, layout(kind, qt, dim, stages).total};
    if (blocks * 4 >= static_cast<long>(sms) * 3) return p;
    if (blocks > best_blocks) {
      best = p;
      best_blocks = blocks;
    }
  }
  return best;
}

__device__ __forceinline__ bool ranks_above(float v, int i, float cv,
                                            int ci) {
  return v > cv || (v == cv && i > ci);
}
__device__ __forceinline__ bool ranks_above(Entry a, Entry b) {
  return ranks_above(a.v, a.i, b.v, b.i);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// the box of `map` at (x elements, y rows) into shared memory, completing on
// `bar`; what lies past the gallery's edge arrives as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// Byte `o` (< 256) of row `r` of a stage: the chunk is two boxes of [128
// rows, 128 bytes] in the 128-byte swizzle, whose 16-byte piece j of row r
// sits at piece j ^ (r % 8), so reads of eight consecutive rows at one
// offset fall in eight distinct bank groups.
__device__ __forceinline__ int swizzled(int r, int o) {
  return (o >> 7) * (kTileRows * kBoxBytes) + r * kBoxBytes +
         ((((o >> 4) & 7) ^ (r & 7)) << 4) + (o & 15);
}

// the 256 consumer threads (barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// ... and whether any of them has `p` set (barrier 2)
__device__ __forceinline__ bool consumers_any(bool p) {
  uint32_t out;
  asm volatile(
      "{\n.reg .pred pi, po;\n"
      "setp.ne.u32 pi, %1, 0;\n"
      "bar.red.or.pred po, 2, %2, pi;\n"
      "selp.u32 %0, 1, 0, po;\n}\n"
      : "=r"(out) : "r"(static_cast<uint32_t>(p)), "n"(kConsumers)
      : "memory");
  return out != 0;
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4 int8 (k, k+1, k+2, k+3 from the low byte) to two bf16 pairs, exactly:
// byte i XOR 0x80 under the exponent of 2^23 is the float 2^23 + v + 128,
// one subtraction gives v, whose 8 significant bits sit in the upper half
__device__ __forceinline__ void int8x4_to_bf16(uint32_t word, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = word ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) -
                   8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) -
                   8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) -
                   8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) -
                   8388736.0f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// One step of a bitonic network over a warp's 64 entries (position p =
// lane + 32 slot): `a` becomes the larger (keep_max) or smaller of itself
// and its partner p ^ stride, lane ^ stride's same slot for stride < 32.
__device__ __forceinline__ void exchange(Entry& a, int stride, bool keep_max) {
  const Entry o = {__shfl_xor_sync(kFull, a.v, stride),
                   __shfl_xor_sync(kFull, a.i, stride)};
  if (ranks_above(o, a) == keep_max) a = o;
}

// ... and for stride 32, the two slots of a lane (the lower one keeps the
// larger when `desc`)
__device__ __forceinline__ void exchange_slots(Entry& a0, Entry& a1,
                                               bool desc) {
  if (ranks_above(a1, a0) == desc) {
    const Entry t = a0;
    a0 = a1;
    a1 = t;
  }
}

// Sort a warp's 64 entries in descending (value, row) order
__device__ __forceinline__ void bitonic_sort(Entry& a0, Entry& a1, int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      if (stride == 32) {
        exchange_slots(a0, a1, true);
        continue;
      }
      const int p0 = lane, p1 = lane + 32;
      exchange(a0, stride, ((p0 & stride) == 0) == ((p0 & size) == 0));
      exchange(a1, stride, ((p1 & stride) == 0) == ((p1 & size) == 0));
    }
  }
}

// Fold up to 64 candidates (unsorted) into a warp's sorted list of 64
// entries (sentinels past its valid ones): sort the candidates, take the
// larger of list[p] and candidate[63 - p] (a bitonic sequence holding the
// best 64 of both), and sort that by a bitonic merge.  All lanes.
__device__ __forceinline__ void bitonic_fold(Entry* list, const Entry* cand,
                                             int m, int lane) {
  const Entry none = {kNegInf, -1};
  Entry c0 = lane < m ? cand[lane] : none;
  Entry c1 = lane + 32 < m ? cand[lane + 32] : none;
  bitonic_sort(c0, c1, lane);
  Entry l0 = list[lane], l1 = list[lane + 32];
  const Entry r0 = {__shfl_sync(kFull, c1.v, 31 - lane),
                    __shfl_sync(kFull, c1.i, 31 - lane)};
  const Entry r1 = {__shfl_sync(kFull, c0.v, 31 - lane),
                    __shfl_sync(kFull, c0.i, 31 - lane)};
  if (ranks_above(r0, l0)) l0 = r0;
  if (ranks_above(r1, l1)) l1 = r1;
  exchange_slots(l0, l1, true);
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    exchange(l0, stride, (lane & stride) == 0);
    exchange(l1, stride, (lane & stride) == 0);
  }
  __syncwarp();
  list[lane] = l0;
  list[lane + 32] = l1;
  __syncwarp();
}

// Fold query ql's candidates (at most `cap` of its count) into its list,
// and raise its threshold to the list's k-th entry.
__device__ __forceinline__ void fold(int ql, Entry* lists, Entry* cands,
                                     Entry* thr, int* cnt, int* nls, int cap,
                                     int k, int lane) {
  const int m = min(cnt[ql], cap);
  Entry* list = lists + ql * kKMax;
  bitonic_fold(list, cands + ql * cap, m, lane);
  if (lane == 0) {
    const int nl = min(nls[ql] + m, kKMax);
    nls[ql] = nl;
    thr[ql] = nl >= k ? list[k - 1] : Entry{kNegInf, -1};
    cnt[ql] = 0;
  }
  __syncwarp();
}

// Per (kind, query tile): the warps' split of a 128-row tile and its query
// tile.  FP32 path: RB x QB warps, a warp 32 TR rows (one a lane) x TQ
// queries.  Tensor-core paths: a warp MT 16-row m-tiles x NT 8-query
// n-tiles.
template <int kKind, int kQT>
struct Shape {
  static constexpr bool kMma = kKind != kF32;
  static constexpr int QB =
      kMma ? 1 : (kQT >= 64 ? 8 : kQT >= 32 ? 4 : 2);
  static constexpr int RB = kConsumerWarps / QB;
  static constexpr int TQ = kQT / QB;                // FP32
  static constexpr int TR = kTileRows / (32 * RB);   // FP32
  static constexpr int NT = kQT / (8 * QB);          // MMA
  static constexpr int MT = kTileRows / (16 * RB);   // MMA
  static constexpr int V = kMma ? MT * NT * 4 : TR * TQ;  // scores a thread
  static constexpr int C = kCandCap;
  static_assert(V <= 32, "one bit a score");
  static_assert(kMma || TR * 32 * RB == kTileRows, "FP32 rows");
  static_assert(!kMma || MT * 16 * RB == kTileRows, "MMA rows");
};

// (row within the tile, query within the tile) of a thread's score e
template <int kKind, int kQT>
__device__ __forceinline__ void score_at(int e, int warp, int lane, int& row,
                                         int& ql) {
  using S = Shape<kKind, kQT>;
  const int rb = warp % S::RB, qb = warp / S::RB;
  if constexpr (S::kMma) {
    const int c = e & 1, h = (e >> 1) & 1, n = (e >> 2) % S::NT,
              m = (e >> 2) / S::NT;
    row = rb * 16 * S::MT + 16 * m + (lane >> 2) + 8 * h;
    ql = qb * 8 * S::NT + 8 * n + 2 * (lane & 3) + c;
  } else {
    const int j = e / S::TQ, i = e % S::TQ;
    row = rb * 32 * S::TR + lane + 32 * j;
    ql = qb * S::TQ + i;
  }
}

// Append a thread's pending scores (bit e of `pending`) that still beat
// their query's k-th entry to the queries' candidate buffers, a slot each
// by an atomic on the query's count: a thread pays for its own survivors
// only.  A score that finds its buffer full stays pending for another
// round.
template <int kKind, int kQT>
__device__ __forceinline__ uint32_t append(uint32_t pending, const float* acc,
                                           int base, int warp, int lane,
                                           const Entry* thr, int* cnt,
                                           Entry* cands) {
  using S = Shape<kKind, kQT>;
#pragma unroll
  for (int e = 0; e < S::V; ++e) {
    if (!(pending >> e & 1)) continue;
    int row, ql;
    score_at<kKind, kQT>(e, warp, lane, row, ql);
    row += base;
    const Entry th = thr[ql];
    if (!ranks_above(acc[e], row, th.v, th.i)) {
      pending &= ~(1u << e);  // the threshold rose past it
      continue;
    }
    const int at = atomicAdd(&cnt[ql], 1);
    if (at < S::C) {
      cands[ql * S::C + at] = Entry{acc[e], row};
      pending &= ~(1u << e);
    }
  }
  return pending;
}

// Block (query tile, split): the top-k of kQT queries over the split's
// gallery rows [split n_rows / splits, (split + 1) n_rows / splits); with
// one split into vals / idx, else into the [n_q, splits, k] scratch, merged
// by the query tile's last block.
template <int kKind, int kQT>
__global__ void __launch_bounds__(kThreads, 1)
topk_stream_kernel(const __grid_constant__ CUtensorMap g_map,
                   const float* __restrict__ q,
                   const float* __restrict__ scales, float* __restrict__ vals,
                   int* __restrict__ idx, float* __restrict__ part_vals,
                   int* __restrict__ part_idx, int* __restrict__ tickets,
                   int n_q, int n_rows, int dim, int k, int stages) {
  using S = Shape<kKind, kQT>;
  extern __shared__ unsigned char smem_raw[];
  // aligned by an offset, not through an integer, so that the compiler
  // keeps every access below in the shared space
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout L = layout(kKind, kQT, dim, stages);
  unsigned char* ring = smem + L.ring;
  unsigned char* q_s = smem + L.queries;
  Entry* lists = reinterpret_cast<Entry*>(smem + L.lists);
  Entry* cands = reinterpret_cast<Entry*>(smem + L.cands);
  Entry* thr = reinterpret_cast<Entry*>(smem + L.thr);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  int* nls = reinterpret_cast<int*>(smem + L.nl);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + stages;
  int* misc = reinterpret_cast<int*>(smem + L.misc);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kQT;
  const int nq_tile = min(kQT, n_q - q0);
  const int split = blockIdx.y, splits = gridDim.y;
  const int row_begin =
      static_cast<int>(static_cast<long long>(split) * n_rows / splits);
  const int row_end =
      static_cast<int>(static_cast<long long>(split + 1) * n_rows / splits);
  const int n_tiles = (row_end - row_begin + kTileRows - 1) / kTileRows;
  const int row_bytes = dim * elem_bytes(kKind);
  const int n_chunks = (row_bytes + kChunkBytes - 1) / kChunkBytes;
  const int qstride = query_stride(kKind, dim);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < kConsumers) {
    if constexpr (kKind == kF32) {
      const int vec = dim / 4;
#pragma unroll 4
      for (int i = tid; i < kQT * vec; i += kConsumers) {
        const int r = i / vec;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < nq_tile) {
          v = *reinterpret_cast<const float4*>(
              q + static_cast<size_t>(q0 + r) * dim + (i - r * vec) * 4);
        }
        reinterpret_cast<float4*>(q_s + r * qstride)[i - r * vec] = v;
      }
    } else {
      // rounded to bf16, zero past D and past the valid queries
      const int pairs = (dim + 31) / 32 * 16;
#pragma unroll 4
      for (int i = tid; i < kQT * pairs; i += kConsumers) {
        const int r = i / pairs, e = (i - r * pairs) * 2;
        float x0 = 0.f, x1 = 0.f;
        if (r < nq_tile && e < dim) {
          const float2 v = *reinterpret_cast<const float2*>(
              q + static_cast<size_t>(q0 + r) * dim + e);
          x0 = v.x;
          x1 = v.y;
        }
        *reinterpret_cast<uint32_t*>(q_s + r * qstride + e * 2) =
            pack_bf16(x0, x1);
      }
    }
    for (int i = tid; i < kQT * kKMax; i += kConsumers) {
      lists[i] = Entry{kNegInf, -1};
    }
    for (int i = tid; i < kQT; i += kConsumers) {
      thr[i] = Entry{kNegInf, -1};
      cnt[i] = 0;
      nls[i] = 0;
    }
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer: one lane issues the boxes
    if (lane == 0) {
      int it = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const int base = row_begin + t * kTileRows;
        for (int c = 0; c < n_chunks; ++c, ++it) {
          const int s = it % stages;
          mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
          // boxes wholly past D are not loaded (nor read)
          const int boxes = min(kBoxes, (row_bytes - c * kChunkBytes +
                                         kBoxBytes - 1) / kBoxBytes);
          mbar_expect(&full[s], boxes * kTileRows * kBoxBytes);
          for (int b = 0; b < boxes; ++b) {
            tma_load(ring + s * kStageBytes + b * kTileRows * kBoxBytes,
                     &g_map, &full[s],
                     (c * kChunkBytes + b * kBoxBytes) / elem_bytes(kKind),
                     base);
          }
        }
      }
    }
    return;
  }

  const int rb = warp % S::RB, qb = warp / S::RB;
  int it = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int base = row_begin + t * kTileRows;
    float acc[S::V];
#pragma unroll
    for (int e = 0; e < S::V; ++e) acc[e] = 0.f;
    float row_scale[S::kMma ? 2 * S::MT : 1];
    if constexpr (kKind == kInt8) {
#pragma unroll
      for (int m = 0; m < S::MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row =
              base + rb * 16 * S::MT + 16 * m + (lane >> 2) + 8 * h;
          row_scale[2 * m + h] = row < row_end ? __ldg(scales + row) : 0.f;
        }
      }
    }
    for (int c = 0; c < n_chunks; ++c, ++it) {
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      const unsigned char* stage = ring + s * kStageBytes;
      const int width = min(chunk_elems(kKind), dim - c * chunk_elems(kKind));
      if constexpr (!S::kMma) {
        // a warp whose queries are all past the tile's valid ones skips
        const int width_q = qb * S::TQ < nq_tile ? width : 0;
        const int r0 = rb * 32 * S::TR + lane;
        const float* qs =
            reinterpret_cast<const float*>(q_s + qb * S::TQ * qstride) +
            c * chunk_elems(kKind);
        const int qf = qstride / 4;
#pragma unroll 2
        for (int d = 0; d < width_q; d += 4) {
          float4 gv[S::TR];
#pragma unroll
          for (int j = 0; j < S::TR; ++j) {
            gv[j] = *reinterpret_cast<const float4*>(
                stage + swizzled(r0 + 32 * j, 4 * d));
          }
#pragma unroll
          for (int i = 0; i < S::TQ; ++i) {
            const float4 x = *reinterpret_cast<const float4*>(qs + i * qf + d);
#pragma unroll
            for (int j = 0; j < S::TR; ++j) {
              float& a = acc[j * S::TQ + i];
              a = fmaf(x.x, gv[j].x, a);
              a = fmaf(x.y, gv[j].y, a);
              a = fmaf(x.z, gv[j].z, a);
              a = fmaf(x.w, gv[j].w, a);
            }
          }
        }
      } else {
        const int gq = lane >> 2, tq = lane & 3;
        const int steps = (width + 31) / 32;
        for (int st = 0; st < steps; ++st) {
          const int k0 = c * chunk_elems(kKind) + st * 32;
          // A: a thread's rows g and g + 8 at elements 4t..4t+3 (first
          // product) and 16+4t..16+4t+3 (second): the same permutation of
          // k as B's, so the sums are the contract's
          uint32_t a[S::MT][8];
#pragma unroll
          for (int m = 0; m < S::MT; ++m) {
            const int ra = rb * 16 * S::MT + 16 * m + gq;
            if constexpr (kKind == kInt8) {
              const int o = st * 32 + 4 * tq;
              const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
                  stage + swizzled(ra, o));
              const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
                  stage + swizzled(ra, o + 16));
              const uint32_t w2 = *reinterpret_cast<const uint32_t*>(
                  stage + swizzled(ra + 8, o));
              const uint32_t w3 = *reinterpret_cast<const uint32_t*>(
                  stage + swizzled(ra + 8, o + 16));
              int8x4_to_bf16(w0, a[m][0], a[m][2]);
              int8x4_to_bf16(w2, a[m][1], a[m][3]);
              int8x4_to_bf16(w1, a[m][4], a[m][6]);
              int8x4_to_bf16(w3, a[m][5], a[m][7]);
            } else {
              const int o = (st * 32 + 4 * tq) * 4;
              const float4 v0 = *reinterpret_cast<const float4*>(
                  stage + swizzled(ra, o));
              const float4 v1 = *reinterpret_cast<const float4*>(
                  stage + swizzled(ra, o + 64));
              const float4 v2 = *reinterpret_cast<const float4*>(
                  stage + swizzled(ra + 8, o));
              const float4 v3 = *reinterpret_cast<const float4*>(
                  stage + swizzled(ra + 8, o + 64));
              a[m][0] = pack_bf16(v0.x, v0.y);
              a[m][2] = pack_bf16(v0.z, v0.w);
              a[m][1] = pack_bf16(v2.x, v2.y);
              a[m][3] = pack_bf16(v2.z, v2.w);
              a[m][4] = pack_bf16(v1.x, v1.y);
              a[m][6] = pack_bf16(v1.z, v1.w);
              a[m][5] = pack_bf16(v3.x, v3.y);
              a[m][7] = pack_bf16(v3.z, v3.w);
            }
          }
#pragma unroll
          for (int n = 0; n < S::NT; ++n) {
            const unsigned char* qrow =
                q_s + (qb * 8 * S::NT + 8 * n + gq) * qstride;
            const uint2 b = *reinterpret_cast<const uint2*>(
                qrow + (k0 + 4 * tq) * 2);
            const uint2 b2 = *reinterpret_cast<const uint2*>(
                qrow + (k0 + 16 + 4 * tq) * 2);
#pragma unroll
            for (int m = 0; m < S::MT; ++m) {
              float* d = acc + (m * S::NT + n) * 4;
              mma_bf16(d, a[m], b.x, b.y);
              mma_bf16(d, a[m] + 4, b2.x, b2.y);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // selection: the scores that beat their query's k-th entry
    uint32_t pending = 0;
#pragma unroll
    for (int e = 0; e < S::V; ++e) {
      int row, ql;
      score_at<kKind, kQT>(e, warp, lane, row, ql);
      row += base;
      if constexpr (kKind == kInt8) {
        acc[e] *= row_scale[2 * ((e >> 2) / S::NT) + ((e >> 1) & 1)];
      }
      if (row < row_end && ql < nq_tile) {
        const Entry th = thr[ql];
        if (ranks_above(acc[e], row, th.v, th.i)) pending |= 1u << e;
      }
    }
    // to the candidate buffers; a query's buffer is folded into its list
    // only when some buffer fills (then every buffer at least half full is
    // folded, and the scores turned away try again against the raised
    // thresholds) and after the last tile
    pending = append<kKind, kQT>(pending, acc, base, warp, lane, thr, cnt,
                                 cands);
    while (consumers_any(pending != 0)) {
      for (int ql = warp; ql < nq_tile; ql += kConsumerWarps) {
        if (cnt[ql] >= S::C / 2) fold(ql, lists, cands, thr, cnt, nls, S::C,
                                      k, lane);
      }
      consumers_sync();
      pending = append<kKind, kQT>(pending, acc, base, warp, lane, thr, cnt,
                                   cands);
    }
  }
  consumers_sync();
  for (int ql = warp; ql < nq_tile; ql += kConsumerWarps) {
    if (cnt[ql]) fold(ql, lists, cands, thr, cnt, nls, S::C, k, lane);
  }
  consumers_sync();

  // the block's lists, sorted, to the output (one split) or the scratch
  // ([n_q, splits, kp], kp = k rounded up to 4: 16-byte rows)
  const int kp = (k + 3) & ~3;
  for (int ql = warp; ql < nq_tile; ql += kConsumerWarps) {
    const size_t at = splits == 1
        ? static_cast<size_t>(q0 + ql) * k
        : (static_cast<size_t>(q0 + ql) * splits + split) * kp;
    float* pv = splits == 1 ? vals : part_vals;
    int* pi = splits == 1 ? idx : part_idx;
    const int nl = nls[ql];
    for (int j = lane; j < k; j += 32) {
      const Entry x = j < nl ? lists[ql * kKMax + j] : Entry{kNegInf, -1};
      pv[at + j] = x.v;
      pi[at + j] = x.i;
    }
  }
  if (splits == 1) return;

  // the last block of the query tile merges the tile's lists
  __threadfence();
  consumers_sync();
  if (tid == 0) {
    const int ticket = atomicAdd(&tickets[blockIdx.x], 1);
    misc[0] = ticket == splits - 1;
    if (ticket == splits - 1) tickets[blockIdx.x] = 0;  // for the next launch
  }
  consumers_sync();
  if (!misc[0]) return;
  __threadfence();

  // Queries a group at a time: the block copies the group's lists into the
  // ring (one coalesced pass, many loads in flight), then each warp merges
  // its queries of the group from there by tournament: k rounds, each
  // taking the best head of the sorted lists (a lane holds the heads of
  // lists lane, lane + 32, ...; a shuffle reduction finds the best) and
  // advancing that list.
  const int per_query = splits * kp;
  int group = (stages * kStageBytes) / (per_query * 8);
  if (group > nq_tile) group = nq_tile;
  Entry* staged = reinterpret_cast<Entry*>(ring);
  constexpr int kHeads = kSplitsMax / 32;
  const Entry none = {kNegInf, -1};
  for (int g0 = 0; g0 < nq_tile; g0 += group) {
    const int gn = min(group, nq_tile - g0);
    const size_t from = static_cast<size_t>(q0 + g0) * per_query;
    const float4* pv4 = reinterpret_cast<const float4*>(part_vals + from);
    const int4* pi4 = reinterpret_cast<const int4*>(part_idx + from);
#pragma unroll 4
    for (int i = tid; i < gn * per_query / 4; i += kConsumers) {
      const float4 v = __ldcg(pv4 + i);
      const int4 r = __ldcg(pi4 + i);
      staged[4 * i] = Entry{v.x, r.x};
      staged[4 * i + 1] = Entry{v.y, r.y};
      staged[4 * i + 2] = Entry{v.z, r.z};
      staged[4 * i + 3] = Entry{v.w, r.w};
    }
    consumers_sync();
    for (int gq = warp; gq < gn; gq += kConsumerWarps) {
      const Entry* ls = staged + gq * per_query;
      Entry head[kHeads];
      int pos[kHeads];
#pragma unroll
      for (int j = 0; j < kHeads; ++j) {
        const int s = lane + 32 * j;
        pos[j] = 0;
        head[j] = s < splits ? ls[s * kp] : none;
      }
      const size_t at = static_cast<size_t>(q0 + g0 + gq) * k;
      for (int r = 0; r < k; ++r) {
        Entry best = none;
        int from_j = 0;
#pragma unroll
        for (int j = 0; j < kHeads; ++j) {
          if (ranks_above(head[j], best)) {
            best = head[j];
            from_j = j;
          }
        }
        Entry w = best;
        int w_lane = lane;
#pragma unroll
        for (int o = 16; o; o >>= 1) {
          const Entry y = {__shfl_xor_sync(kFull, w.v, o),
                           __shfl_xor_sync(kFull, w.i, o)};
          const int y_lane = __shfl_xor_sync(kFull, w_lane, o);
          if (ranks_above(y, w)) {
            w = y;
            w_lane = y_lane;
          }
        }
        if (lane == 0) {
          vals[at + r] = w.v;
          idx[at + r] = w.i;
        }
        if (lane == w_lane && w.i >= 0) {
#pragma unroll
          for (int j = 0; j < kHeads; ++j) {
            if (j == from_j) {
              ++pos[j];
              head[j] =
                  pos[j] < k ? ls[(lane + 32 * j) * kp + pos[j]] : none;
            }
          }
        }
      }
    }
    consumers_sync();
  }
}

using KernelFn = void (*)(CUtensorMap, const float*, const float*, float*,
                          int*, float*, int*, int*, int, int, int, int, int);

template <int kKind>
KernelFn kernel_for(int qt) {
  switch (qt) {
    case 64: return topk_stream_kernel<kKind, 64>;
    case 32: return topk_stream_kernel<kKind, 32>;
    case 16: return topk_stream_kernel<kKind, 16>;
    default: return topk_stream_kernel<kKind, 8>;
  }
}

int sm_count() {
  static int cached[64] = {0};
  static std::mutex lock;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  std::lock_guard<std::mutex> hold(lock);
  if (!cached[dev]) {
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return cached[dev];
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The gallery [n_g, dim] (f32 or int8) in boxes of [128 rows, 128 bytes],
// 128-byte swizzle, zeros past its edges; made once per (address, rows,
// dim, kind), since a served gallery stays where it is.  A map holds only
// the address, the dimensions, the strides and the box, so a tensor that
// takes a freed gallery's address with the same shape has the same map.
cudaError_t gallery_map(CUtensorMap* map, const void* g, int n_g, int dim,
                        int kind) {
  struct Cached {
    const void* ptr;
    int n_g, dim, kind;
    CUtensorMap map;
  };
  constexpr int kEntries = 16;
  static Cached table[kEntries];
  static int used = 0, next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < used; ++i) {
    const Cached& c = table[i];
    if (c.ptr == g && c.n_g == n_g && c.dim == dim && c.kind == kind) {
      *map = c.map;
      return cudaSuccess;
    }
  }
  EncodeTiled encode = nullptr;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const int esize = elem_bytes(kind);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(dim),
                              static_cast<cuuint64_t>(n_g)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(dim) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBoxBytes / esize),
                             static_cast<cuuint32_t>(kTileRows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map,
      kind == kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(g), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  table[next] = Cached{g, n_g, dim, kind, *map};
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  return cudaSuccess;
}

// One launch of the plan's kernel; the caller's (q_tile, splits) must be
// the plan's (it sized the scratch by them).  Returns cudaError_t.
int launch(int kind, const float* q, const unsigned char* g,
           const float* scales, void* vals, void* idx, void* part_vals,
           void* part_idx, void* tickets, int n_q, int n_g, int dim, int k,
           int valid_gallery, int q_tile, int splits, void* stream) {
  if (n_q <= 0) return cudaSuccess;
  const int n_rows = valid_gallery < n_g ? valid_gallery : n_g;
  if (n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (!sms) return static_cast<int>(cudaErrorInvalidDevice);
  const Plan p = make_plan(kind, n_q, n_rows, dim, sms);
  if (!p.qt || p.qt != q_tile || p.splits != splits || k < 1 || k > kKMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KernelFn fn = kind == kF32 ? kernel_for<kF32>(p.qt)
              : kind == kBf16 ? kernel_for<kBf16>(p.qt)
                              : kernel_for<kInt8>(p.qt);
  {  // the shared-memory attribute, once a (device, kernel)
    static std::mutex lock;
    static int set[64][3][4] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    const int slot = p.qt == 64 ? 0 : p.qt == 32 ? 1 : p.qt == 16 ? 2 : 3;
    std::lock_guard<std::mutex> hold(lock);
    if (set[dev][kind][slot] < p.smem) {
      const cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (err != cudaSuccess) return static_cast<int>(err);
      set[dev][kind][slot] = kSmemMax;
    }
  }
  CUtensorMap map;
  const cudaError_t err = gallery_map(&map, g, n_g, dim, kind);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (n_q + p.qt - 1) / p.qt;
  fn<<<dim3(q_tiles, p.splits), kThreads, p.smem,
       static_cast<cudaStream_t>(stream)>>>(
      map, q, scales, static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(part_vals), static_cast<int*>(part_idx),
      static_cast<int*>(tickets), n_q, n_rows, dim, k, p.stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  The Python wrapper checks
// dtype, shape, contiguity, 16-byte alignment, k <= 64 and D, computes the
// plan (ops/ranking.py:topk_plan), allocates the [n_q, splits, k] scratch
// when splits > 1 and passes its device's ticket counters (zeroed, one a
// query tile).  Rows at or past valid_gallery are never scored.  round_bf16
// rounds both operands to bf16 before the products (the tensor-core path).
// Each returns cudaError_t.
extern "C" int topk_similarity_f32(const void* q, const void* g, void* vals,
                                   void* idx, void* part_vals, void* part_idx,
                                   void* tickets, int n_q, int n_g, int dim,
                                   int k, int valid_gallery, int q_tile,
                                   int splits, int round_bf16, void* stream) {
  return launch(round_bf16 ? kBf16 : kF32, static_cast<const float*>(q),
                static_cast<const unsigned char*>(g), nullptr, vals, idx,
                part_vals, part_idx, tickets, n_q, n_g, dim, k,
                valid_gallery, q_tile, splits, stream);
}

// As above over an int8 gallery with its per-row f32 scales (D % 16 == 0).
extern "C" int topk_similarity_int8(const void* q, const void* g,
                                    const void* scales, void* vals, void* idx,
                                    void* part_vals, void* part_idx,
                                    void* tickets, int n_q, int n_g, int dim,
                                    int k, int valid_gallery, int q_tile,
                                    int splits, void* stream) {
  return launch(kInt8, static_cast<const float*>(q),
                static_cast<const unsigned char*>(g),
                static_cast<const float*>(scales), vals, idx, part_vals,
                part_idx, tickets, n_q, n_g, dim, k, valid_gallery, q_tile,
                splits, stream);
}

// The plan of the current device for (kind: 0 f32, 1 bf16, 2 int8, n_q,
// n_rows, dim): out = {q_tile, splits, stages, shared bytes} (chip_smoke.py
// holds it against ops/ranking.py:topk_plan).
extern "C" int topk_similarity_plan(int kind, int n_q, int n_rows, int dim,
                                    int* out) {
  const int sms = sm_count();
  if (!sms) return static_cast<int>(cudaErrorInvalidDevice);
  const Plan p = make_plan(kind, n_q, n_rows, dim, sms);
  out[0] = p.qt;
  out[1] = p.splits;
  out[2] = p.stages;
  out[3] = p.smem;
  return 0;
}
