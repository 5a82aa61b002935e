// One lane of the O(nd) trace-point wave: a forward or reverse pass from a
// seed diagonal to its trimmed tip, with the pebble pool the host walks into
// trace points (damapper_tpu.ops.wave.extract_*_traces).
//
// A line-for-line port of the host oracle's forward_wave / reverse_wave
// (damapper_tpu/ops/wave.py; reference align.c:353-1720) for damapper's one
// call shape: a single seed diagonal and no borders.  The per-diagonal band
// state lives in a ring of W slots (slot = diag & (W-1)); a lane whose band
// or pebble count outgrows its capacity reports `overflow` and the engine
// reruns it on the host oracle.
//
// The same source compiles for the host (the CPU FFI target, used by the
// tests) and for the GPU (one lane per thread, wave_ffi.cu).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define WAVE_HD __host__ __device__ __forceinline__
#else
#define WAVE_HD inline
#endif

namespace wave {

constexpr int PATH_LEN = 60;
constexpr uint64_t PATH_TOP = 1ull << PATH_LEN;
constexpr uint64_t PATH_INT = PATH_TOP - 1;
constexpr uint64_t PATH_MASK = (PATH_TOP << 1) - 1;
constexpr int TRIM_LEN = 15;
constexpr int TRIM_MASK = 0x7FFF;
constexpr int TRIM_MLAG = 250;
constexpr int WAVE_LAG = 30;
constexpr int32_t IMAX = 0x7FFFFFFF;

// lane inputs, one row of int32 per lane
enum { L_ABASE, L_BBASE, L_MIDA, L_K0, L_AOFF, L_BOFF, NLANE };
// lane outputs, one row of int32 per lane
enum {
  O_TRIMA, O_TRIMY, O_TRIMD, O_TRIMHA, O_TRIMHB,
  O_MOREM, O_MOREA, O_MOREY, O_MORED, O_MOREHA, O_MOREHB,
  O_AVAIL, O_OVERFLOW, O_WAVES, NOUT
};

struct Seq {
  const uint8_t* p;
  int64_t n;
  // bytes outside the buffer read as the sentinel 4
  WAVE_HD int operator()(int64_t i) const {
    return (i < 0 || i >= n) ? 4 : p[i];
  }
};

struct Spec {
  int ts;                 // trace spacing
  int pave;               // ave-path threshold for trim points
  const int16_t* table;   // suffix-positivity tables (AlignSpec.table/score)
  const int16_t* score;
};

template <int W>
struct Band {
  int32_t V[W], M[W], HA[W], HB[W], NA[W], NB[W];
  uint64_t T[W];
};

WAVE_HD int floordiv(int a, int b) {
  int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// pebble pool of one lane: rows (ptr, diag, diff, mark), capacity P
struct Pool {
  int32_t* c;
  int P;
  int avail;
  bool ovf;
  WAVE_HD int drop(int ptr, int diag, int diff, int mark) {
    int h = avail++;
    if (h < P) {
      int32_t* r = c + 4 * h;
      r[0] = ptr; r[1] = diag; r[2] = diff; r[3] = mark;
    } else {
      ovf = true;
    }
    return h;
  }
  WAVE_HD int mark(int h) const {
    if (h < 0) h += avail;            // the oracle's cells[-1]
    return (h >= 0 && h < P) ? c[4 * h + 3] : 0;
  }
};

struct Tip {
  int besta, besty, lasta, trima, trimy, trimd, trimha, trimhb;
  int morem, morea, morey, mored, moreha, morehb;
};

WAVE_HD bool trim_ok(const Spec& s, uint64_t b) {
  return s.table[b & TRIM_MASK] >= 0 &&
         s.table[(b >> TRIM_LEN) & TRIM_MASK] + s.score[b & TRIM_MASK] >= 0;
}

template <int W>
WAVE_HD void grab(const Band<W>& bd, Tip& t, int kc, int dif, bool set_d) {
  const int s = kc & (W - 1);
  if (t.morem <= bd.M[s]) {
    t.morem = bd.M[s];
    t.morea = bd.V[s];
    t.morey = floordiv(t.morea - kc, 2);
    if (set_d) t.mored = dif;
    t.moreha = bd.HA[s];
    t.morehb = bd.HB[s];
  }
}

WAVE_HD void write_out(int32_t* out, const Tip& t, const Pool& pl, int dif) {
  out[O_TRIMA] = t.trima;   out[O_TRIMY] = t.trimy;   out[O_TRIMD] = t.trimd;
  out[O_TRIMHA] = t.trimha; out[O_TRIMHB] = t.trimhb;
  out[O_MOREM] = t.morem;   out[O_MOREA] = t.morea;   out[O_MOREY] = t.morey;
  out[O_MORED] = t.mored;   out[O_MOREHA] = t.moreha; out[O_MOREHB] = t.morehb;
  out[O_AVAIL] = pl.avail;  out[O_OVERFLOW] = pl.ovf ? 1 : 0;
  out[O_WAVES] = dif;
}

WAVE_HD void init_tip(Tip& t, int mida, int hgh) {
  t.besta = t.trima = t.morea = t.lasta = mida;
  t.besty = t.trimy = t.morey = (mida - hgh) >> 1;
  t.trimd = t.mored = 0;
  t.trimha = t.moreha = 0;
  t.trimhb = t.morehb = 1;
  t.morem = -1;
}

// forward pass (oracle forward_wave; align.c:353-1011)
template <int W>
WAVE_HD void forward_lane(const int32_t* lane, Seq A, Seq B, const Spec& sp,
                          Pool& pl, Band<W>& bd, int32_t* out) {
  constexpr int Wm = W - 1;
  const int64_t abase = lane[L_ABASE], bbase = lane[L_BBASE];
  const int mida = lane[L_MIDA], k0 = lane[L_K0];
  const int aoff = lane[L_AOFF], boff = lane[L_BOFF];
  const int TS = sp.ts;
  int32_t *V = bd.V, *M = bd.M, *HA = bd.HA, *HB = bd.HB;
  int32_t *NA = bd.NA, *NB = bd.NB;
  uint64_t* T = bd.T;

  int hgh = k0, low = k0, dif = 0;
  bool more = true;
  int aclip = IMAX, bclip = -IMAX;
  Tip t;
  init_tip(t, mida, hgh);

  {  // the 0-wave from the midline (align.c:420-556)
    const int k = k0;
    int y = (mida - k) >> 1;
    int na = (floordiv((y + k) + (TS - aoff), TS) - 1) * TS + aoff;
    int ha = pl.drop(-1, k, 0, na);
    na += TS;
    int nb = (floordiv(y + (TS - boff), TS) - 1) * TS + boff;
    int hb = pl.drop(-1, k, 0, nb);
    nb += TS;
    while (true) {
      const int c = B(bbase + y);
      if (c == 4) {
        more = false;
        if (bclip < k) bclip = k;
        break;
      }
      const int d = A(abase + y + k);
      if (c != d) {
        if (d == 4) { more = false; aclip = k; }
        break;
      }
      y += 1;
    }
    const int c = (y << 1) + k;
    while (y + k >= na) { ha = pl.drop(ha, k, 0, na); na += TS; }
    while (y >= nb) { hb = pl.drop(hb, k, 0, nb); nb += TS; }
    if (c > t.besta) {
      t.besta = t.trima = t.lasta = c;
      t.besty = t.trimy = y;
      t.trimha = ha; t.trimhb = hb;
    }
    const int s = k & Wm;
    V[s] = c; T[s] = PATH_INT; M[s] = PATH_LEN;
    HA[s] = ha; HB[s] = hb; NA[s] = na; NB[s] = nb;
  }
  if (!more) {
    if (B(bbase + t.besty) != 4 && A(abase + t.besta - t.besty) != 4)
      more = true;
    if (hgh >= aclip) { hgh = aclip - 1; grab(bd, t, aclip, dif, false); }
    if (low <= bclip) { low = bclip + 1; grab(bd, t, bclip, dif, false); }
    aclip = IMAX; bclip = -IMAX;
  }

  // successive waves (align.c:592-898)
  while (more && t.lasta >= t.besta - TRIM_MLAG && !pl.ovf) {
    low -= 1;
    hgh += 1;
    if (hgh - low + 4 >= W || pl.avail + W >= pl.P) { pl.ovf = true; break; }
    NA[low & Wm] = NA[(low + 1) & Wm];
    NB[low & Wm] = NB[(low + 1) & Wm];
    V[low & Wm] = -1;
    NA[hgh & Wm] = NA[(hgh - 1) & Wm];
    NB[hgh & Wm] = NB[(hgh - 1) & Wm];
    V[hgh & Wm] = -1;
    int am = -1;
    dif += 1;
    int ac = -1;
    V[(hgh + 1) & Wm] = -1;
    V[(low - 1) & Wm] = -1;
    uint64_t tt = PATH_INT;
    int n = PATH_LEN, ua = -1, ub = -1;
    for (int k = hgh; k >= low; --k) {
      const int ap = ac;
      ac = am;
      const int sd = (k - 1) & Wm, s = k & Wm;
      am = V[sd];
      int c, m, ha, hb;
      uint64_t b;
      if (ac < am) {
        if (am < ap) { c = ap + 1; m = n; b = tt; ha = ua; hb = ub; }
        else { c = am + 1; m = M[sd]; b = T[sd]; ha = HA[sd]; hb = HB[sd]; }
      } else {
        if (ac < ap) { c = ap + 1; m = n; b = tt; ha = ua; hb = ub; }
        else { c = ac + 2; m = M[s]; b = T[s]; ha = HA[s]; hb = HB[s]; }
      }
      if (b & PATH_TOP) m -= 1;
      b = (b << 1) & PATH_MASK;

      int y = (c - k) >> 1;
      while (true) {
        const int cb = B(bbase + y);
        if (cb == 4) {
          more = false;
          if (bclip < k) bclip = k;
          break;
        }
        const int da = A(abase + y + k);
        if (cb != da) {
          if (da == 4) { more = false; aclip = k; }
          break;
        }
        y += 1;
        if ((b & PATH_TOP) == 0) m += 1;
        b = ((b << 1) | 1) & PATH_MASK;
      }
      c = (y << 1) + k;

      while (y + k >= NA[s]) {
        if (pl.mark(ha) < NA[s]) ha = pl.drop(ha, k, dif, NA[s]);
        NA[s] += TS;
      }
      while (y >= NB[s]) {
        if (pl.mark(hb) < NB[s]) hb = pl.drop(hb, k, dif, NB[s]);
        NB[s] += TS;
      }

      if (c > t.besta) {
        t.besta = c; t.besty = y;
        if (m >= sp.pave) {
          t.lasta = c;
          if (trim_ok(sp, b)) {
            t.trima = c; t.trimy = y; t.trimd = dif;
            t.trimha = ha; t.trimhb = hb;
          }
        }
      }
      tt = T[s]; n = M[s]; ua = HA[s]; ub = HB[s];
      V[s] = c; T[s] = b; M[s] = m; HA[s] = ha; HB[s] = hb;
    }

    if (!more) {
      if (B(bbase + t.besty) != 4 && A(abase + t.besta - t.besty) != 4)
        more = true;
      if (hgh >= aclip) { hgh = aclip - 1; grab(bd, t, aclip, dif, true); }
      if (low <= bclip) { low = bclip + 1; grab(bd, t, bclip, dif, true); }
      aclip = IMAX; bclip = -IMAX;
    }

    const int nthr = t.besta - WAVE_LAG;
    while (hgh >= low) {
      if (V[hgh & Wm] < nthr) {
        hgh -= 1;
      } else {
        while (V[low & Wm] < nthr) low += 1;
        break;
      }
    }
  }
  write_out(out, t, pl, dif);
}

// reverse pass (oracle reverse_wave; align.c:1015-1720): the reference
// decrements its sequence pointers, so every read is at index - 1
template <int W>
WAVE_HD void reverse_lane(const int32_t* lane, Seq A, Seq B, const Spec& sp,
                          Pool& pl, Band<W>& bd, int32_t* out) {
  constexpr int Wm = W - 1;
  const int64_t abase = lane[L_ABASE] - 1, bbase = lane[L_BBASE] - 1;
  const int mida = lane[L_MIDA], k0 = lane[L_K0];
  const int aoff = lane[L_AOFF], boff = lane[L_BOFF];
  const int TS = sp.ts;
  int32_t *V = bd.V, *M = bd.M, *HA = bd.HA, *HB = bd.HB;
  int32_t *NA = bd.NA, *NB = bd.NB;
  uint64_t* T = bd.T;

  int hgh = k0, low = k0, dif = 0;
  bool more = true;
  int aclip = -IMAX, bclip = IMAX;
  Tip t;
  init_tip(t, mida, hgh);

  {
    const int k = k0;
    int y = (mida - k) >> 1;
    int na = (floordiv((y + k) + (TS - aoff) - 1, TS) - 1) * TS + aoff;
    int ha = pl.drop(-1, k, 0, y + k);
    int nb = (floordiv(y + (TS - boff) - 1, TS) - 1) * TS + boff;
    int hb = pl.drop(-1, k, 0, y);
    while (true) {
      const int c = B(bbase + y);
      if (c == 4) {
        more = false;
        if (bclip > k) bclip = k;
        break;
      }
      const int d = A(abase + y + k);
      if (c != d) {
        if (d == 4) { more = false; aclip = k; }
        break;
      }
      y -= 1;
    }
    const int c = (y << 1) + k;
    while (y + k <= na) { ha = pl.drop(ha, k, 0, na); na -= TS; }
    while (y <= nb) { hb = pl.drop(hb, k, 0, nb); nb -= TS; }
    if (c < t.besta) {
      t.besta = t.trima = t.lasta = c;
      t.besty = t.trimy = y;
      t.trimha = ha; t.trimhb = hb;
    }
    const int s = k & Wm;
    V[s] = c; T[s] = PATH_INT; M[s] = PATH_LEN;
    HA[s] = ha; HB[s] = hb; NA[s] = na; NB[s] = nb;
  }
  if (!more) {
    if (B(bbase + t.besty) != 4 && A(abase + t.besta - t.besty) != 4)
      more = true;
    if (low <= aclip) { low = aclip + 1; grab(bd, t, aclip, dif, false); }
    if (hgh >= bclip) { hgh = bclip - 1; grab(bd, t, bclip, dif, false); }
    aclip = -IMAX; bclip = IMAX;
  }

  while (more && t.lasta <= t.besta + TRIM_MLAG && !pl.ovf) {
    low -= 1;
    hgh += 1;
    if (hgh - low + 4 >= W || pl.avail + W >= pl.P) { pl.ovf = true; break; }
    NA[low & Wm] = NA[(low + 1) & Wm];
    NB[low & Wm] = NB[(low + 1) & Wm];
    V[low & Wm] = IMAX;
    int ap = IMAX;
    NA[hgh & Wm] = NA[(hgh - 1) & Wm];
    NB[hgh & Wm] = NB[(hgh - 1) & Wm];
    V[hgh & Wm] = IMAX;
    dif += 1;
    int ac = IMAX;
    V[(hgh + 1) & Wm] = IMAX;
    V[(low - 1) & Wm] = IMAX;
    uint64_t tt = PATH_INT;
    int n = PATH_LEN, ua = -1, ub = -1;
    for (int k = low; k <= hgh; ++k) {
      const int am = ac;
      ac = ap;
      const int sd = (k + 1) & Wm, s = k & Wm;
      ap = V[sd];
      int c, m, ha, hb;
      uint64_t b;
      if (ac > ap) {
        if (ap > am) { c = am - 1; m = n; b = tt; ha = ua; hb = ub; }
        else { c = ap - 1; m = M[sd]; b = T[sd]; ha = HA[sd]; hb = HB[sd]; }
      } else {
        if (ac > am) { c = am - 1; m = n; b = tt; ha = ua; hb = ub; }
        else { c = ac - 2; m = M[s]; b = T[s]; ha = HA[s]; hb = HB[s]; }
      }
      if (b & PATH_TOP) m -= 1;
      b = (b << 1) & PATH_MASK;

      int y = (c - k) >> 1;
      while (true) {
        const int cb = B(bbase + y);
        if (cb == 4) {
          more = false;
          if (bclip > k) bclip = k;
          break;
        }
        const int da = A(abase + y + k);
        if (cb != da) {
          if (da == 4) { more = false; aclip = k; }
          break;
        }
        y -= 1;
        if ((b & PATH_TOP) == 0) m += 1;
        b = ((b << 1) | 1) & PATH_MASK;
      }
      c = (y << 1) + k;

      while (y + k <= NA[s]) {
        if (pl.mark(ha) > NA[s]) ha = pl.drop(ha, k, dif, NA[s]);
        NA[s] -= TS;
      }
      while (y <= NB[s]) {
        if (pl.mark(hb) > NB[s]) hb = pl.drop(hb, k, dif, NB[s]);
        NB[s] -= TS;
      }

      if (c < t.besta) {
        t.besta = c; t.besty = y;
        if (m >= sp.pave) {
          t.lasta = c;
          if (trim_ok(sp, b)) {
            t.trima = c; t.trimy = y; t.trimd = dif;
            t.trimha = ha; t.trimhb = hb;
          }
        }
      }
      tt = T[s]; n = M[s]; ua = HA[s]; ub = HB[s];
      V[s] = c; T[s] = b; M[s] = m; HA[s] = ha; HB[s] = hb;
    }

    if (!more) {
      if (B(bbase + t.besty) != 4 && A(abase + t.besta - t.besty) != 4)
        more = true;
      if (low <= aclip) { low = aclip + 1; grab(bd, t, aclip, dif, true); }
      if (hgh >= bclip) { hgh = bclip - 1; grab(bd, t, bclip, dif, true); }
      aclip = -IMAX; bclip = IMAX;
    }

    const int nthr = t.besta + WAVE_LAG;
    while (hgh >= low) {
      if (V[hgh & Wm] > nthr) {
        hgh -= 1;
      } else {
        while (V[low & Wm] > nthr) low += 1;
        break;
      }
    }
  }
  write_out(out, t, pl, dif);
}

template <int W>
WAVE_HD void run_lane(bool reverse, const int32_t* lane, Seq A, Seq B,
                      const Spec& sp, int32_t* pool, int P, int32_t* out) {
  Band<W> bd;
  Pool pl{pool, P, 0, false};
  if (reverse)
    reverse_lane<W>(lane, A, B, sp, pl, bd, out);
  else
    forward_lane<W>(lane, A, B, sp, pl, bd, out);
}

}  // namespace wave
