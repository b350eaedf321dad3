// Kernel K1: the CABAC arithmetic coder (spec 9.3.4) over packed records.
//
// Replaces tpu264/entropy/cabac_pallas.py `_engine_kernel` (built by
// `make_slice_encoder`).  The binarizer emits one int32 record per run of
// bins, kind << 30 | a << 14 | b:
//   kind 0: a = ctxIdx, b = bin | count << 1   (count bins, same context)
//   kind 1: a = bypass value, MSB first, b = nbits <= 16
//   kind 2: a = terminate bin; a != 0 ends the slice (flush + stop bit) and
//           must be the slice's last record
// and this kernel replays each slice's records through the coder and writes
// the payload as big-endian 32-bit words (the first stream bit is the MSB
// of word 0, zero past the payload) plus its size in bytes.
//
// What bounds it on the card: a serial dependency chain, not bytes (a 720p
// slice reads 2.5 MB of records and writes 56 KB).  Every bin reads the
// range the previous bin wrote, so within a slice the range/low chain is
// one thread, and a thread with no other warp to hide behind waits out
// every instruction: about 4 cycles an integer operation, 21 a
// shared-memory load, 23 a count-leading-zeros, and more for a branch
// (`tools/lone_thread.py` measures them).  Its time is bins x the
// instructions a bin x those waits.  Slices are the only wide axis (one
// CUDA block each).  The design takes everything off that thread that does
// not need the range, and leaves it a loop without branches, as a pipeline
// of three stages over chunks of records in shared memory, one block
// barrier a chunk:
//  - warp 2 copies the next chunk of records from device memory;
//  - warp 1 resolves the chunk before into one operation a bin.  The state
//    sequence of a context does not depend on the range: a context is one
//    byte, state << 1 | mps, and a 128-entry table holds per context byte
//    the four rangeTabLPS values, the renormalisation shift each of them
//    needs, and the next context byte for bin 0 and for bin 1.  32 records
//    are taken at once, one a lane; of the lanes that meet in one context
//    the first walks the group in record order.  A context bin leaves as
//    (four rangeTabLPS bytes, their shifts, is-LPS flag), a bypass bit as
//    (0, bypass flag, bit), a terminate bin 0 as an MPS bin with
//    rangeLPS 2; only the final terminate bin and runs of more than
//    `kMaxRun` bins are left to a branch;
//  - thread 0 codes the operations of the chunk before that, four a turn,
//    two to a 128-bit load issued a turn ahead.  An operation is
//    straight-line code: a byte select on range >> 6, a subtract, selects
//    on the flags, one shift; the renormalisation shift comes from the
//    operation or from rangeMPS < 256, not from counting zeros;
//  - byte-wise output with carry: `low` keeps the 10-bit coder window plus
//    up to 15 pending bits below a carry bit; when 8 are pending the top
//    byte (with its carry in bit 8) is stored into a shared-memory list,
//    without a branch (the store is always made, the list grows or not).
//    At the end of a chunk the same thread runs the list through the byte
//    sink: 0xFF bytes are counted as outstanding, and a carry is added to
//    the last byte held back before it is committed.  No loop over bits
//    and none over outstanding bits.  The stream's first bit (always 0) is
//    dropped by starting with -1 pending bits.
// After the coder ends, all threads zero the words past the payload.
//
// If a slice would write past `out_cap` words, the kernel stops storing and
// reports nbytes = -1.  The spec's procedure goes on coding whatever follows
// a terminate bin 1, bit by bit after the stop bit, and so does the plain
// version; this coder has padded to a whole byte by then.  No slice has
// such records, and one that does is refused: nbytes = -2.  The wrapper's
// caller raises on either.
//
// Built with -DK1_PROFILE, each stage counts the cycles it works and prints
// them beside the cycles of the launch (`tools/profile_frame.py
// --k1-stages`).

#include <cstdint>
#include <cuda_runtime.h>
#ifdef K1_PROFILE
#include <cstdio>
#endif

namespace {

constexpr int kNumCtx = 460;
constexpr int kCtxSlots = 512;   // a context index out of range codes in a mod 512
constexpr int kThreads = 96;     // warp 0 codes, warp 1 resolves, warp 2 loads
constexpr int kChunk = 128;      // records a chunk
constexpr int kMaxRun = 4;       // a longer run of bins stays one operation
constexpr int kMaxOps = 16;      // operations a record: a bypass record's bits
constexpr int kOpCap = kChunk * kMaxOps;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// flags of an operation (its y word); a context bin also carries the four
// renormalisation shifts of its rangeTabLPS values in bits 3..14
constexpr uint32_t kOpLps = 1u, kOpBypass = 2u, kOpBypassBit = 4u;
constexpr uint32_t kOpRun = 1u << 30;     // x = count << 1 | bin | ctx byte << 14
constexpr uint32_t kOpFinal = 1u << 31;   // terminate bin 1: flush

struct CabacTables {
  uint8_t range_lps[256];   // rangeTabLPS[state][(range >> 6) & 3]
  uint8_t trans_mps[64];
  uint8_t trans_lps[64];
};

// Payload bytes, MSB first, with the last byte held back for a carry.
// Everything that touches the sink is inlined, so that the sink and the
// coder stay in registers: a call would spill the coding loop's registers
// to local memory, and a lone thread waits out every such load.
struct ByteSink {
  int32_t* out;
  int cap;            // words
  uint32_t acc;       // bytes of the word being filled
  int nbytes;         // bytes committed
  int pending;        // byte held back for a carry, -1: none yet
  int outstanding;    // 0xFF bytes after it
  int overflow;
};

__device__ __forceinline__ void sink_commit(ByteSink* s, uint32_t byte) {
  s->acc = (s->acc << 8) | byte;
  if ((++s->nbytes & 3) == 0) {
    const int w = (s->nbytes >> 2) - 1;
    if (w < s->cap) s->out[w] = (int32_t)s->acc;
    else s->overflow = 1;
  }
}

// `o`: the next 8 payload bits, with a carry into what came before them in
// bit 8
__device__ __forceinline__ void sink_put(ByteSink* s, uint32_t o) {
  if (o == 0xFFu) {
    ++s->outstanding;
    return;
  }
  const uint32_t carry = o >> 8;
  if (s->pending >= 0) sink_commit(s, (uint32_t)s->pending + carry);
#pragma unroll 1
  for (; s->outstanding > 0; --s->outstanding)
    sink_commit(s, (0xFFu + carry) & 0xFFu);
  s->pending = (int)(o & 0xFFu);
}

__device__ __forceinline__ void sink_finish(ByteSink* s) {
  if (s->pending >= 0) sink_commit(s, (uint32_t)s->pending);
#pragma unroll 1
  for (; s->outstanding > 0; --s->outstanding) sink_commit(s, 0xFFu);
  s->pending = -1;
  if (s->nbytes & 3) {              // zero-pad the last partial word
    const int w = s->nbytes >> 2;
    if (w < s->cap)
      s->out[w] = (int32_t)(s->acc << (8 * (4 - (s->nbytes & 3))));
    else
      s->overflow = 1;
  }
}

// The coder's registers: the 10-bit window of `low` with `q` pending bits
// below it and a carry bit above, and the range.  The methods here serve
// the rare operations (long runs, the flush) and write to the sink at once.
struct Coder {
  uint32_t low, range;
  int q;

  // q >= 8: the top byte (with its carry) leaves
  __device__ __forceinline__ void put_byte(ByteSink* s) {
    const uint32_t o = low >> (q + 2);
    low &= (1u << (q + 2)) - 1u;
    q -= 8;
    sink_put(s, o);
  }
  __device__ __forceinline__ void renorm(ByteSink* s) {
    const int sh = __clz(range) - 23;       // 0 for range >= 256
    range <<= sh;
    low <<= sh;
    q += sh;
    if (q >= 8) put_byte(s);
  }
};

// terminate bin 1 (`c.range` already less 2): the spec's flush writes the
// window's two top bits after 7 renormalisation shifts, then the stop bit
__device__ __forceinline__ void coder_flush(Coder c, ByteSink* s) {
  c.low += c.range;
  c.range = 2;
  c.renorm(s);
  uint32_t v = ((c.low >> 8) << 1) | 1u;    // q + 3 bits below the carry
  int w = c.q + 3;
  const int pad = (8 - (w & 7)) & 7;
  v <<= pad;
  w += pad;
#pragma unroll 1
  for (; w > 0; w -= 8) {
    sink_put(s, v >> (w - 8));
    v &= (1u << (w - 8)) - 1u;
  }
  sink_finish(s);
}

// Table word of a context byte: x = the four rangeTabLPS values, one a
// byte; y = next context byte for bin 0 | for bin 1 << 8 | the four
// renormalisation shifts of x's values, 3 bits each, << 16.
__device__ __forceinline__ uint32_t op_flags(uint2 t, uint32_t cb,
                                             uint32_t bin) {
  return (((t.y >> 16) & 0xFFFu) << 3) | ((cb ^ bin) & 1u);
}

// Stage 2 of the pipeline, one warp: turn `cnt` records into operations,
// (x, y) each, and return how many.  A lane takes one record of a batch of
// 32 and finds where its operations go by a prefix sum over the batch; of
// the lanes that share a context (the group that `__match_any_sync` finds)
// the first walks the group's records in order, one table load a bin, and
// all groups walk at once.
__device__ __forceinline__ int resolve_chunk(
    const int32_t* __restrict__ rb, uint2* __restrict__ ops, int cnt,
    uint8_t* ctx, const uint2* tab, int* offs, int lane, int last,
    int* stray) {
  int filled = 0;
  for (int j = 0; j < cnt; j += 32) {
    const int i = j + lane;
    const uint32_t p = i < cnt ? (uint32_t)rb[i] : 0u;   // 0 codes nothing
    const uint32_t kind = p >> 30;
    const int a = (int)(p >> 14) & 0xFFFF;
    const int b = (int)(p & 0x3FFFu);
    const bool is_ctx = kind == 0u;
    int n_ops = 0;
    if (kind == 0u) n_ops = (b >> 1) <= kMaxRun ? (b >> 1) : 1;
    else if (kind == 1u) n_ops = b > 16 ? 16 : b;
    else n_ops = 1;                       // terminate
    int incl = n_ops;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFullMask, incl, d);
      if (lane >= d) incl += t;
    }
    const int at = filled + incl - n_ops;
    filled += __shfl_sync(kFullMask, incl, 31);
    offs[lane] = at;
    const unsigned same = __match_any_sync(
        kFullMask, is_ctx ? (a & (kCtxSlots - 1)) : kCtxSlots + lane);
    __syncwarp();
    if (kind == 1u) {
      const uint32_t val = (uint32_t)a;
      for (int t = 0; t < n_ops; ++t)
        ops[at + t] = make_uint2(
            0u, kOpBypass | (((val >> (n_ops - 1 - t)) & 1u) ? kOpBypassBit
                                                              : 0u));
    } else if (kind >= 2u) {
      if (a != 0 && i != last) *stray = 1;  // records follow the flush
      ops[at] = a != 0 ? make_uint2(0u, kOpFinal)
                       : make_uint2(0x02020202u, 0u);
    } else if (is_ctx && lane == __ffs(same) - 1) {
      uint32_t cb = ctx[a & (kCtxSlots - 1)];
      for (unsigned m = same; m != 0u; m &= m - 1u) {
        const int l = __ffs(m) - 1;
        const uint32_t q = (uint32_t)rb[j + l] & 0x3FFFu;
        const uint32_t bin = q & 1u;
        const int shift = (int)bin * 8;
        const int k = (int)(q >> 1);
        int o = offs[l];
        uint2 t = tab[cb];
        if (k <= kMaxRun) {
          for (int r = 0; r < k; ++r) {
            ops[o++] = make_uint2(t.x, op_flags(t, cb, bin));
            cb = (t.y >> shift) & 0xFFu;
            if (r + 1 < k) t = tab[cb];
          }
        } else {
          ops[o] = make_uint2(q | (cb << 14), kOpRun);
          for (int r = 0; r < k; ++r) {
            const uint32_t nb = (t.y >> shift) & 0xFFu;
            if (nb == cb) break;          // a state that maps to itself
            cb = nb;
            t = tab[cb];
          }
        }
      }
      ctx[a & (kCtxSlots - 1)] = (uint8_t)cb;
    }
    __syncwarp();
  }
  // the coder takes four operations a turn: fill the last turn with
  // operations that code nothing (an MPS bin with rangeLPS 0)
  if (lane < 4 && filled + lane < ((filled + 3) & ~3))
    ops[filled + lane] = make_uint2(0u, 0u);
  return filled;
}

__global__ void __launch_bounds__(kThreads) cabac_engine_kernel(
    const int32_t* __restrict__ records, int rec_stride,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ init,
    CabacTables tables, int32_t* __restrict__ words, int out_cap,
    int32_t* __restrict__ nbytes) {
  __shared__ uint2 tab[128];              // see `op_flags`
  __shared__ uint8_t ctx[kCtxSlots];      // context byte of each context
  __shared__ int32_t rec[2][kChunk];
  // two operations to a word; + 2 words: the coder reads four ahead
  __shared__ uint4 ops[2][kOpCap / 2 + 2];
  __shared__ int n_ops[2];
  __shared__ int offs[32];
  __shared__ uint16_t obytes[kOpCap + 8]; // a byte, its carry in bit 8
  __shared__ int first_free_word;
  __shared__ int stray;                   // a record follows terminate bin 1

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  int32_t* out = words + (int64_t)s * out_cap;
  const int32_t* src = records + (int64_t)s * rec_stride;
  const int n = counts[s];
  const int n_chunks = (n + kChunk - 1) / kChunk;

  for (int cb = tid; cb < 128; cb += kThreads) {
    const int st = cb >> 1, mps = cb & 1;
    uint32_t rl = 0, shifts = 0;
    for (int i = 0; i < 4; ++i) {
      const uint32_t v = tables.range_lps[st * 4 + i];
      rl |= v << (8 * i);
      shifts |= (uint32_t)((__clz(v | 1u) - 23) & 7) << (3 * i);
    }
    const uint32_t to_mps = ((uint32_t)tables.trans_mps[st] << 1) | mps;
    const uint32_t to_lps = ((uint32_t)tables.trans_lps[st] << 1) |
                            (uint32_t)(mps ^ (st == 0));
    const uint32_t next0 = mps == 0 ? to_mps : to_lps;
    const uint32_t next1 = mps == 1 ? to_mps : to_lps;
    tab[cb] = make_uint2(rl, next0 | (next1 << 8) | (shifts << 16));
  }
  for (int i = tid; i < kCtxSlots; i += kThreads)  // init: state | mps << 8
    ctx[i] = i < kNumCtx
                 ? (uint8_t)(((init[i] & 0x3F) << 1) | ((init[i] >> 8) & 1))
                 : 0;
  if (tid == 0) stray = 0;
  __syncthreads();

  Coder c{0u, 510u, -1};
  ByteSink sink{out, out_cap, 0u, 0, -1, 0, 0};
  bool done = false;
  int final_nbytes = 0;

  // step `it`: the loader fetches chunk it, the resolver takes chunk it - 1,
  // the coder chunk it - 2; one block barrier a step
#ifdef K1_PROFILE
  long long busy = 0, t_all = clock64();
#endif
  for (int it = 0; it < n_chunks + 2; ++it) {
#ifdef K1_PROFILE
    const long long t_in = clock64();
#endif
    if (tid >= 64) {
      if (it < n_chunks) {
        const int base = it * kChunk;
        const int cnt = n - base < kChunk ? n - base : kChunk;
        for (int j = tid - 64; j < cnt; j += 32)
          rec[it & 1][j] = src[base + j];
      }
    } else if (tid >= 32) {
      const int ch = it - 1;
      if (ch >= 0 && ch < n_chunks) {
        const int base = ch * kChunk;
        const int filled = resolve_chunk(
            rec[ch & 1], reinterpret_cast<uint2*>(ops[ch & 1]),
            n - base < kChunk ? n - base : kChunk, ctx, tab, offs, tid - 32,
            n - 1 - base, &stray);
        if (tid == 32) n_ops[ch & 1] = filled;
      }
    } else if (tid == 0 && it >= 2 && !done) {
      const uint4* pb = ops[it & 1];
      const int cnt = n_ops[it & 1];
      int n_out = 0;                       // bytes in `obytes`
      auto drain = [&]() {
#pragma unroll 1
        for (int i = 0; i < n_out; ++i) sink_put(&sink, obytes[i]);
        n_out = 0;
      };
      // one operation, no branch
      auto code = [&](uint32_t x, uint32_t y) {
        const uint32_t sel = c.range >> 6;                  // 4..7
        const uint32_t rlps = __byte_perm(0u, x, sel);
        const uint32_t rmps = c.range - rlps;
        const bool lps = (y & kOpLps) != 0u;
        const bool byp = (y & kOpBypass) != 0u;
        const uint32_t sh_lps = (y >> (3u * sel - 9u)) & 7u;
        const uint32_t sh_ctx = lps ? sh_lps : (rmps < 256u ? 1u : 0u);
        const uint32_t sh = byp ? 1u : sh_ctx;
        const uint32_t add_ctx = lps ? rmps : 0u;
        const uint32_t add_byp = (y & kOpBypassBit) ? c.range : 0u;
        c.low = ((c.low + add_ctx) << sh) + add_byp;
        c.range = byp ? c.range : ((lps ? rlps : rmps) << sh_ctx);
        c.q += (int)sh;
        const bool full = c.q >= 8;
        obytes[n_out] = (uint16_t)(c.low >> (c.q + 2));     // kept if full
        n_out += full ? 1 : 0;
        c.low = full ? c.low & ((1u << (c.q + 2)) - 1u) : c.low;
        c.q -= full ? 8 : 0;
      };
      // the rare operations; they write to the sink at once
      auto code_rare = [&](uint32_t x, uint32_t y) {
        drain();
        if (y & kOpFinal) {
          c.range -= 2u;
          coder_flush(c, &sink);
          done = true;
          final_nbytes = sink.overflow ? -1 : sink.nbytes;
          sink.cap = 0;                    // whatever follows writes nothing
          return;
        }
        const uint32_t bin = x & 1u;       // a long run of bins in one context
        uint32_t cb = (x >> 14) & 0x7Fu;
#pragma unroll 1
        for (int k = (int)(x & 0x3FFFu) >> 1; k > 0; --k) {
          const uint2 t = tab[cb];
          const uint32_t rlps = __byte_perm(0u, t.x, c.range >> 6);
          const uint32_t rmps = c.range - rlps;
          const bool lps = ((cb ^ bin) & 1u) != 0u;
          c.low += lps ? rmps : 0u;
          c.range = lps ? rlps : rmps;
          c.renorm(&sink);
          cb = (t.y >> (bin * 8u)) & 0xFFu;
        }
      };
      uint4 c0 = pb[0], c1 = pb[1];
#pragma unroll 1
      for (int g = 0; g < cnt && !done; g += 4) {
        const uint4 n0 = pb[(g >> 1) + 2], n1 = pb[(g >> 1) + 3];
        if (((c0.y | c0.w | c1.y | c1.w) >> 30) == 0u) {
          code(c0.x, c0.y);
          code(c0.z, c0.w);
          code(c1.x, c1.y);
          code(c1.z, c1.w);
        } else {
          const uint2* e = reinterpret_cast<const uint2*>(pb) + g;
#pragma unroll 1
          for (int t = 0; t < 4 && !done; ++t) {
            if (e[t].y >> 30) code_rare(e[t].x, e[t].y);
            else code(e[t].x, e[t].y);
          }
        }
        c0 = n0;
        c1 = n1;
      }
      drain();
    }
#ifdef K1_PROFILE
    busy += clock64() - t_in;
#endif
    __syncthreads();
  }
#ifdef K1_PROFILE
  if ((tid & 31) == 0)
    printf("K1 profile: slice %d warp %d busy %lld of %lld cycles\n", s,
           tid >> 5, busy, clock64() - t_all);
#endif

  if (tid == 0) {
    if (!done) {                          // no terminating record
      sink_finish(&sink);
      final_nbytes = sink.overflow ? -1 : sink.nbytes;
    }
    if (stray) final_nbytes = -2;
    nbytes[s] = final_nbytes;
    first_free_word = final_nbytes < 0 ? out_cap : (final_nbytes + 3) >> 2;
  }
  __syncthreads();
  for (int i = first_free_word + tid; i < out_cap; i += kThreads) out[i] = 0;
}

}  // namespace

extern "C" int tpu264_cabac_engine(const int32_t* records, int rec_stride,
                                   const int32_t* counts, const int32_t* init,
                                   const int32_t* tables384, int32_t* words,
                                   int out_cap, int32_t* nbytes, int n_slices,
                                   void* stream) {
  CabacTables t;
  for (int i = 0; i < 256; ++i) t.range_lps[i] = (uint8_t)tables384[i];
  for (int i = 0; i < 64; ++i) {
    t.trans_mps[i] = (uint8_t)tables384[256 + i];
    t.trans_lps[i] = (uint8_t)tables384[320 + i];
  }
  if (n_slices > 0) {
    cabac_engine_kernel<<<n_slices, kThreads, 0, (cudaStream_t)stream>>>(
        records, rec_stride, counts, init, t, words, out_cap, nbytes);
  }
  return (int)cudaGetLastError();
}
