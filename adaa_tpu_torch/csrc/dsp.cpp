// dsp — host-side audio data-prep library of adaa_tpu_torch.
//
// The reference's per-item decode pipeline runs in C via libsox
// (silence trim / resample, reference src/datasets/base_dataset.py:273-322).
// This library holds the port's native equivalents for the data loader:
// PCM normalization, the exact sox `silence` state machine, the GSM 06.10
// round trip of the phone-call simulation, a FLAC decoder and
// repeat-pad/cut. A copy of the JAX package's native/adaa_dsp.cpp, with the
// same plain C ABI, bound through ctypes by adaa_tpu_torch/data/native.py.
//
// Built at first use by adaa_tpu_torch/ops/_build.py into
// adaa_tpu_torch/_build/libdsp.so (g++ -O3 -std=c++17 -fPIC -shared).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <memory>
#include <vector>

extern "C" {

// int16 PCM -> float32 in [-1, 1) (torchaudio.load normalize=True).
void adaa_normalize_i16(const int16_t* in, float* out, int64_t n) {
    constexpr float k = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) out[i] = in[i] * k;
}

// Exact port of the sox `silence` effect state machine (sox 14.4.x
// silence.c) for mono float input — the engine behind the reference's
// SOX_SILENCE trim (reference src/datasets/base_dataset.py:29-33,
// 273-286, applied via torchaudio.sox_effects.apply_effects_tensor).
//
// Semantics reproduced:
//  * per-sample activity = sliding RMS over the trailing `window_size`
//    samples (sox uses rate/50, i.e. 20 ms), including the current
//    sample, compared >= threshold;
//  * SILENCE_TRIM: discard input until `start_duration` CONSECUTIVE
//    above-threshold samples are seen; that triggering run (the
//    holdoff buffer) is emitted once `start_periods` runs completed;
//  * SILENCE_COPY: copy through; below-threshold samples accumulate in
//    a holdoff buffer — if sound resumes before `stop_duration`
//    samples, the holdoff is flushed (short pauses kept); if the
//    holdoff fills, the silence is DISCARDED and (stop_periods < 0 =
//    sox "restart" mode) the machine returns to SILENCE_TRIM with a
//    cleared RMS window; without restart, processing stops (samples
//    after the silence are dropped);
//  * drain at EOF: a partial stop-holdoff (trailing silence shorter
//    than stop_duration) is flushed; a partial start-holdoff (sound
//    run shorter than start_duration) is discarded — both as in sox's
//    drain().
//
// Returns the number of output samples written to `out` (capacity n).
int64_t adaa_sox_silence(const float* x, int64_t n, float* out,
                         int32_t start_periods, int64_t start_duration,
                         float start_threshold,
                         int32_t stop_periods_in, int64_t stop_duration,
                         float stop_threshold, int64_t window_size) {
    const bool do_start = start_periods > 0;
    const bool restart = stop_periods_in < 0;
    const int32_t stop_periods = restart ? -stop_periods_in : stop_periods_in;
    const bool do_stop = stop_periods_in != 0;
    if (window_size < 1) window_size = 1;
    if (start_duration < 1) start_duration = 1;
    if (stop_duration < 1) stop_duration = 1;

    // sliding-RMS circular window of squared samples (silence.c
    // compute_rms/update_rms: compute includes the incoming sample in
    // place of the oldest; update then commits it)
    std::unique_ptr<double[]> win(new double[window_size]());
    int64_t cur = 0;
    double rms_sum = 0.0;
    const double dsize = (double)window_size;

    enum { TRIM, COPY } mode = do_start ? TRIM : COPY;
    int64_t i = 0, m = 0;
    int32_t start_found = 0, stop_found = 0;
    int64_t hold_start = 0, hold_len = 0;    // start holdoff (contiguous run)
    int64_t shold_start = 0, shold_len = 0;  // stop holdoff (contiguous run)

    while (i < n) {
        if (mode == TRIM) {
            const double s = (double)x[i];
            const double r = std::sqrt((rms_sum - win[cur] + s * s) / dsize);
            const bool above = r >= (double)start_threshold;
            rms_sum -= win[cur];
            win[cur] = s * s;
            rms_sum += win[cur];
            if (++cur >= window_size) cur = 0;
            if (above) {
                if (hold_len == 0) hold_start = i;
                ++hold_len;
                ++i;
                if (hold_len >= start_duration) {
                    if (++start_found >= start_periods) {
                        // SILENCE_TRIM_FLUSH: emit the triggering run
                        std::memcpy(out + m, x + hold_start,
                                    (size_t)hold_len * sizeof(float));
                        m += hold_len;
                        hold_len = 0;
                        mode = COPY;
                    } else {
                        hold_len = 0;  // completed period trashed, keep looking
                    }
                }
            } else {
                hold_len = 0;  // run broken: discard holdoff
                ++i;
            }
        } else {  // COPY
            if (!do_stop) {  // blind copy of the remainder
                std::memcpy(out + m, x + i, (size_t)(n - i) * sizeof(float));
                m += n - i;
                i = n;
                break;
            }
            const double s = (double)x[i];
            const double r = std::sqrt((rms_sum - win[cur] + s * s) / dsize);
            const bool above = r >= (double)stop_threshold;
            if (above && shold_len > 0) {
                // SILENCE_COPY_FLUSH: short pause kept; the current
                // sample is re-processed (sox does not update the RMS
                // window before the goto)
                std::memcpy(out + m, x + shold_start,
                            (size_t)shold_len * sizeof(float));
                m += shold_len;
                shold_len = 0;
                continue;
            }
            rms_sum -= win[cur];
            win[cur] = s * s;
            rms_sum += win[cur];
            if (++cur >= window_size) cur = 0;
            if (above) {
                out[m++] = x[i++];
            } else {
                if (shold_len == 0) shold_start = i;
                ++shold_len;
                ++i;
                if (shold_len >= stop_duration) {
                    if (++stop_found >= stop_periods) {
                        shold_len = 0;  // the long silence is discarded
                        if (restart) {
                            stop_found = 0;
                            start_found = 0;
                            hold_len = 0;
                            std::memset(win.get(), 0,
                                        (size_t)window_size * sizeof(double));
                            rms_sum = 0.0;
                            cur = 0;
                            mode = TRIM;
                        } else {
                            return m;  // SILENCE_STOP: drop the rest
                        }
                    } else {
                        // flush full period and keep looking
                        std::memcpy(out + m, x + shold_start,
                                    (size_t)shold_len * sizeof(float));
                        m += shold_len;
                        shold_len = 0;
                    }
                }
            }
        }
    }
    // drain(): flush a partial trailing stop-holdoff; a partial
    // start-holdoff (mode TRIM at EOF) is discarded
    if (mode == COPY && shold_len > 0) {
        std::memcpy(out + m, x + shold_start, (size_t)shold_len * sizeof(float));
        m += shold_len;
    }
    return m;
}

// ---------------------------------------------------------------------------
// GSM 06.10 full-rate (RPE-LTP) codec round trip — the reference's
// phone-call simulation ends with torchaudio's apply_codec(format="gsm")
// (reference src/datasets/base_dataset.py:321). This is an
// algorithmically faithful implementation of the ETSI 06.10 codec
// (preemphasis, Schur LPC -> LAR quantization, lattice short-term
// filtering, long-term predictor with 2-bit gain, RPE grid selection
// and 3-bit APCM with the spec's quantization tables) using a float
// signal path with the spec's integer quantizers — not a bit-exact
// clone of libgsm, but the same codec structure and quantization
// grids, which is what shapes the audio for data augmentation.
// ---------------------------------------------------------------------------

namespace gsm0610 {

// LAR quantization (spec table 4.1, natural units)
static const double A_[8] = {20.0, 20.0, 20.0, 20.0, 13.637, 15.0, 8.334, 8.824};
static const double B_[8] = {0.0, 0.0, 4.0, -5.0, 0.184, -3.5, -0.666, -2.235};
static const int MIC[8] = {-32, -32, -16, -16, -8, -8, -4, -4};
static const int MAC[8] = {31, 31, 15, 15, 7, 7, 3, 3};
// LTP gain decision/quantization levels (DLB/QLB, /32768)
static const double DLB[3] = {0.2, 0.5, 0.8};
static const double QLB[4] = {0.10, 0.35, 0.65, 1.000030517578125};
// RPE weighting filter (H/8192)
static const double H_[11] = {-134 / 8192.0, -374 / 8192.0, 0.0, 2054 / 8192.0,
                              5741 / 8192.0, 8192 / 8192.0, 5741 / 8192.0,
                              2054 / 8192.0, 0.0, -374 / 8192.0, -134 / 8192.0};
// APCM mantissa normalization tables
static const int NRFAC[8] = {29128, 26215, 23832, 21846, 20165, 18725, 17476, 16384};
static const int FAC[8] = {18431, 20479, 22527, 24575, 26623, 28671, 30719, 32767};

struct Codes {
    int LARc[8];
    int Nc[4], bc[4], Mc[4], xmaxc[4], xMc[4][13];
};

struct EncState {
    double z = 0.0, L_z2 = 0.0;   // offset compensation state
    double mp = 0.0;              // preemphasis memory
    double u[8] = {0};            // analysis lattice
    double LARpp_prev[8] = {0};
    double dp[120 + 160] = {0};   // reconstructed short-term residual
};

struct DecState {
    double v[9] = {0};            // synthesis lattice
    double LARpp_prev[8] = {0};
    double drp[120 + 160] = {0};
    double msr = 0.0;             // deemphasis memory
};

static inline int nint(double z) {
    return (int)(z >= 0 ? z + 0.5 : z - 0.5);
}

// LAR <-> reflection coefficient piecewise maps (spec 4.2.5 / 4.2.9.1)
static inline double r_to_lar(double r) {
    double a = std::fabs(r), s = r < 0 ? -1.0 : 1.0;
    if (a < 0.675) return r;
    if (a < 0.950) return s * (2.0 * a - 0.675);
    return s * (8.0 * a - 6.375);
}
static inline double lar_to_r(double lar) {
    double a = std::fabs(lar), s = lar < 0 ? -1.0 : 1.0;
    if (a < 0.675) return lar;
    if (a < 1.225) return s * (0.5 * a + 0.3375);
    return s * (0.125 * a + 0.796875);
}

// decoded xmaxc -> (exp, mant) of the dequantized block maximum
static inline void xmaxc_exp_mant(int xmaxc, int* exp_out, int* mant_out) {
    int exp = 0;
    if (xmaxc > 15) exp = (xmaxc >> 3) - 1;
    int mant = xmaxc - (exp << 3);
    if (mant == 0) {
        exp = -4;
        mant = 7;
    } else {
        while (mant <= 7) {
            mant = (mant << 1) | 1;
            exp--;
        }
        mant -= 8;
    }
    *exp_out = exp;
    *mant_out = mant;
}

// dequantized RPE pulse value for 3-bit code xmc given xmaxc exp/mant
static inline double apcm_dequant(int xmc, int exp, int mant) {
    // ((2*xmc - 7) << 12) * FAC[mant]/32768 >> (6 - exp)
    return (2.0 * xmc - 7.0) * 4096.0 * (FAC[mant] / 32768.0) *
           std::pow(2.0, exp - 6.0);
}

// per-subframe LAR interpolation factors (spec 4.2.9.1)
static inline void interp_lars(const double* prev, const double* cur, int j,
                               double rp[8]) {
    double wp, wc;
    switch (j) {
        case 0: wp = 0.75, wc = 0.25; break;
        case 1: wp = 0.50, wc = 0.50; break;
        case 2: wp = 0.25, wc = 0.75; break;
        default: wp = 0.0, wc = 1.0; break;
    }
    for (int i = 0; i < 8; ++i) {
        double lar = wp * prev[i] + wc * cur[i];
        rp[i] = lar_to_r(lar);
    }
}

// encode + immediately decode one 160-sample frame (int16-domain doubles)
static void frame_roundtrip(EncState* es, DecState* ds, const double* sin160,
                            double* out160) {
    // -- preprocessing: offset compensation + preemphasis (spec 4.2.1-2)
    double s[160];
    for (int k = 0; k < 160; ++k) {
        double s1 = sin160[k] - es->z;
        es->z = sin160[k];
        double sof = s1 + (32735.0 / 32768.0) * es->L_z2;
        es->L_z2 = sof;
        s[k] = sof - (28180.0 / 32768.0) * es->mp;
        es->mp = sof;
    }

    // -- LPC: autocorrelation + Schur recursion (spec 4.2.4-5)
    double acf[9];
    for (int i = 0; i <= 8; ++i) {
        double sum = 0.0;
        for (int k = i; k < 160; ++k) sum += s[k] * s[k - i];
        acf[i] = sum;
    }
    double r[8] = {0};
    if (acf[0] > 0.0) {
        double P[9], K[9];
        for (int i = 0; i <= 8; ++i) P[i] = acf[i];
        for (int i = 1; i <= 8; ++i) K[i] = acf[i];
        // Schur: iteratively extract reflection coefficients
        double p0 = P[0];
        double pp[9], kk[9];
        for (int i = 0; i <= 8; ++i) pp[i] = P[i];
        for (int i = 1; i <= 8; ++i) kk[i] = K[i];
        for (int n = 0; n < 8; ++n) {
            if (pp[0] <= 0.0) { for (int m = n; m < 8; ++m) r[m] = 0.0; break; }
            double rn = -pp[1] / pp[0];
            if (rn > 1.0) rn = 1.0;
            if (rn < -1.0) rn = -1.0;
            r[n] = rn;
            if (n == 7) break;
            // Schur update
            double np[9], nk[9];
            np[0] = pp[0] + pp[1] * rn;
            for (int m = 1; m <= 7 - n; ++m) {
                np[m] = pp[m + 1] + kk[m] * rn;
                nk[m] = kk[m] + pp[m + 1] * rn;
            }
            for (int m = 0; m <= 7 - n; ++m) pp[m] = np[m];
            for (int m = 1; m <= 7 - n; ++m) kk[m] = nk[m];
        }
        (void)p0;
    }

    // -- LAR quantization (spec 4.2.6-7)
    Codes c;
    double LARpp[8];
    for (int i = 0; i < 8; ++i) {
        double lar = r_to_lar(r[i]);
        int larc = nint(A_[i] * lar + B_[i]);
        if (larc < MIC[i]) larc = MIC[i];
        if (larc > MAC[i]) larc = MAC[i];
        c.LARc[i] = larc;
        LARpp[i] = (larc - B_[i]) / A_[i];  // decoded LAR (spec 4.2.8)
    }

    // -- short-term analysis + LTP/RPE per subframe
    double d[160];
    for (int j = 0; j < 4; ++j) {
        double rp[8];
        interp_lars(es->LARpp_prev, LARpp, j, rp);
        for (int k = 40 * j; k < 40 * (j + 1); ++k) {
            double di = s[k], sav = di;
            for (int i = 0; i < 8; ++i) {
                double temp = es->u[i] + rp[i] * di;
                di = di + rp[i] * es->u[i];
                es->u[i] = sav;
                sav = temp;
            }
            d[k] = di;
        }

        double* dsub = d + 40 * j;
        double* dp = es->dp + 120 + 40 * j;  // current subframe position

        // LTP: lag search over reconstructed residual history (4.2.11)
        int Nc = 40;
        double best = -1.0;
        for (int lam = 40; lam <= 120; ++lam) {
            double corr = 0.0;
            for (int k = 0; k < 40; ++k) corr += dsub[k] * dp[k - lam];
            if (corr > best) { best = corr; Nc = lam; }
        }
        double power = 0.0;
        for (int k = 0; k < 40; ++k) power += dp[k - Nc] * dp[k - Nc];
        double b = (power > 0.0 && best > 0.0) ? best / power : 0.0;
        int bc = 0;
        while (bc < 3 && b > DLB[bc]) ++bc;
        double bp = QLB[bc];
        c.Nc[j] = Nc;
        c.bc[j] = bc;

        // short-term residual minus LTP estimate (4.2.12)
        double e[40];
        for (int k = 0; k < 40; ++k) e[k] = dsub[k] - bp * dp[k - Nc];

        // RPE: weighting filter + grid decimation (4.2.13-14)
        double x[40];
        for (int k = 0; k < 40; ++k) {
            double sum = 0.0;
            for (int i = 0; i < 11; ++i) {
                int idx = k + 5 - i;
                if (idx >= 0 && idx < 40) sum += H_[i] * e[idx];
            }
            x[k] = sum;
        }
        int Mc = 0;
        double em = -1.0;
        for (int m = 0; m < 4; ++m) {
            double energy = 0.0;
            for (int i = 0; i < 13; ++i) {
                double v = x[m + 3 * i];
                energy += v * v;
            }
            if (energy > em) { em = energy; Mc = m; }
        }
        c.Mc[j] = Mc;
        double xM[13];
        for (int i = 0; i < 13; ++i) xM[i] = x[Mc + 3 * i];

        // APCM quantization of the 13 pulses (4.2.15, integer quantizers)
        double xmax = 0.0;
        for (int i = 0; i < 13; ++i) xmax = std::max(xmax, std::fabs(xM[i]));
        int ixmax = (int)std::min(32767.0, std::floor(xmax));
        int exp = 0, temp = ixmax >> 9, itest = 0;
        for (int i = 0; i <= 5; ++i) {
            itest |= (temp <= 0);
            temp >>= 1;
            if (!itest) ++exp;
        }
        int xmaxc = (ixmax >> (exp + 5)) + (exp << 3);
        if (xmaxc > 63) xmaxc = 63;
        c.xmaxc[j] = xmaxc;
        int dexp, dmant;
        xmaxc_exp_mant(xmaxc, &dexp, &dmant);
        for (int i = 0; i < 13; ++i) {
            // temp = (xM << (6-dexp)) * NRFAC[mant] >> 15 >> 12, + 4
            double t = xM[i] * std::pow(2.0, 6 - dexp) *
                       (NRFAC[dmant] / 32768.0) / 4096.0;
            int xmc = (int)std::floor(t) + 4;
            if (xmc < 0) xmc = 0;
            if (xmc > 7) xmc = 7;
            c.xMc[j][i] = xmc;
        }

        // local decoding: reconstruct residual, update encoder history
        double ep[40] = {0};
        for (int i = 0; i < 13; ++i)
            ep[Mc + 3 * i] = apcm_dequant(c.xMc[j][i], dexp, dmant);
        for (int k = 0; k < 40; ++k) dp[k] = ep[k] + bp * dp[k - Nc];
    }
    es->LARpp_prev[0] = LARpp[0];
    for (int i = 0; i < 8; ++i) es->LARpp_prev[i] = LARpp[i];
    // shift encoder residual history left by one frame
    std::memmove(es->dp, es->dp + 160, 120 * sizeof(double));

    // ----------------- DECODER -----------------
    double LARpp_d[8];
    for (int i = 0; i < 8; ++i) LARpp_d[i] = (c.LARc[i] - B_[i]) / A_[i];

    double wt[160];
    for (int j = 0; j < 4; ++j) {
        double* drp = ds->drp + 120 + 40 * j;
        int dexp, dmant;
        xmaxc_exp_mant(c.xmaxc[j], &dexp, &dmant);
        double erp[40] = {0};
        for (int i = 0; i < 13; ++i)
            erp[c.Mc[j] + 3 * i] = apcm_dequant(c.xMc[j][i], dexp, dmant);
        double bp = QLB[c.bc[j]];
        for (int k = 0; k < 40; ++k)
            drp[k] = erp[k] + bp * drp[k - c.Nc[j]];
        for (int k = 0; k < 40; ++k) wt[40 * j + k] = drp[k];
    }
    std::memmove(ds->drp, ds->drp + 160, 120 * sizeof(double));

    for (int j = 0; j < 4; ++j) {
        double rrp[8];
        interp_lars(ds->LARpp_prev, LARpp_d, j, rrp);
        for (int k = 40 * j; k < 40 * (j + 1); ++k) {
            double sri = wt[k];
            for (int i = 0; i < 8; ++i) {
                sri = sri - rrp[7 - i] * ds->v[7 - i];
                ds->v[8 - i] = ds->v[7 - i] + rrp[7 - i] * sri;
            }
            ds->v[0] = sri;
            // deemphasis (4.3.5)
            double sr = sri + (28180.0 / 32768.0) * ds->msr;
            ds->msr = sr;
            out160[k] = sr;
        }
    }
    for (int i = 0; i < 8; ++i) ds->LARpp_prev[i] = LARpp_d[i];
}

}  // namespace gsm0610

// Encode+decode `n` float samples ([-1,1]) through GSM 06.10; the final
// partial frame is zero-padded (out must have capacity ceil(n/160)*160).
// Returns the number of output samples written, or -1 on error.
int64_t adaa_gsm_roundtrip(const float* x, int64_t n, float* out) {
    if (n <= 0) return 0;
    gsm0610::EncState es;
    gsm0610::DecState ds;
    int64_t frames = (n + 159) / 160;
    double in160[160], out160[160];
    for (int64_t f = 0; f < frames; ++f) {
        for (int k = 0; k < 160; ++k) {
            int64_t idx = f * 160 + k;
            double v = idx < n ? (double)x[idx] : 0.0;
            // int16 domain like the spec (sample scaling)
            in160[k] = std::max(-32768.0, std::min(32767.0, v * 32768.0));
        }
        gsm0610::frame_roundtrip(&es, &ds, in160, out160);
        for (int k = 0; k < 160; ++k) {
            double v = out160[k] / 32768.0;
            out[f * 160 + k] =
                (float)std::max(-1.0, std::min(32767.0 / 32768.0, v));
        }
    }
    return frames * 160;
}

// Repeat-pad / cut to exactly `cut` samples (PadDataset.apply_pad).
// ---------------------------------------------------------------------------
// FLAC decoder (subset sufficient for ASVspoof2021-DF eval corpora:
// reference decode site src/datasets/base_dataset.py:165 via
// torchaudio/libsndfile). Supports: 8/12/16/20/24-bit, mono/stereo +
// left-side/right-side/mid-side decorrelation, CONSTANT / VERBATIM /
// FIXED(0-4) / LPC subframes, rice & rice2 residual partitions with
// escape codes, wasted bits. CRCs are parsed but not verified (decode
// integrity is covered by the round-trip tests in
// tests/test_native.py).
// ---------------------------------------------------------------------------

namespace flac {

struct BitReader {
    const uint8_t* data;
    int64_t nbytes;
    int64_t bytepos = 0;
    int bitpos = 0;  // 0..7, MSB first
    bool error = false;

    uint64_t bits(int n) {
        uint64_t v = 0;
        for (int i = 0; i < n; ++i) {
            if (bytepos >= nbytes) { error = true; return 0; }
            v = (v << 1) | ((data[bytepos] >> (7 - bitpos)) & 1);
            if (++bitpos == 8) { bitpos = 0; ++bytepos; }
        }
        return v;
    }
    int64_t sbits(int n) {
        uint64_t v = bits(n);
        if (n > 0 && (v >> (n - 1)) & 1) return (int64_t)v - (1LL << n);
        return (int64_t)v;
    }
    uint32_t unary() {
        uint32_t q = 0;
        while (!error && bits(1) == 0) ++q;
        return q;
    }
    void align() { if (bitpos) { bitpos = 0; ++bytepos; } }
    bool eof() const { return bytepos >= nbytes; }
};

inline int64_t rice(BitReader& br, int param) {
    uint64_t q = br.unary();
    uint64_t v = (q << param) | br.bits(param);
    return (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
}

// Decode one subframe into x[0..blocksize); bps includes the +1 for
// side channels. Returns false on parse error.
inline bool subframe(BitReader& br, int64_t* x, int blocksize, int bps) {
    if (br.bits(1) != 0) return false;  // padding bit
    int type = (int)br.bits(6);
    int wasted = 0;
    if (br.bits(1)) wasted = 1 + (int)br.unary();
    bps -= wasted;

    int order = 0;
    enum { CONST, VERB, FIXED, LPC } kind;
    if (type == 0) kind = CONST;
    else if (type == 1) kind = VERB;
    else if ((type & 0x38) == 0x08 && (type & 7) <= 4) {
        kind = FIXED; order = type & 7;
    } else if (type & 0x20) { kind = LPC; order = (type & 0x1f) + 1; }
    else return false;

    int precision = 0, shift = 0;
    int64_t coefs[32];
    if (kind == CONST) {
        int64_t v = br.sbits(bps);
        for (int i = 0; i < blocksize; ++i) x[i] = v;
    } else if (kind == VERB) {
        for (int i = 0; i < blocksize; ++i) x[i] = br.sbits(bps);
    } else {
        for (int i = 0; i < order; ++i) x[i] = br.sbits(bps);
        if (kind == LPC) {
            precision = (int)br.bits(4) + 1;
            if (precision == 16) return false;  // 0b1111 invalid
            shift = (int)br.sbits(5);
            if (shift < 0) return false;
            for (int i = 0; i < order; ++i) coefs[i] = br.sbits(precision);
        }
        // residual
        int method = (int)br.bits(2);
        if (method > 1) return false;
        int plen = method == 0 ? 4 : 5;
        int escape = method == 0 ? 0xF : 0x1F;
        int porder = (int)br.bits(4);
        int nparts = 1 << porder;
        int64_t idx = order;
        for (int p = 0; p < nparts; ++p) {
            int64_t cnt = blocksize >> porder;
            if (p == 0) cnt -= order;
            if (cnt < 0) return false;
            int param = (int)br.bits(plen);
            if (param == escape) {
                int raw = (int)br.bits(5);
                for (int64_t i = 0; i < cnt; ++i) x[idx++] = br.sbits(raw);
            } else {
                for (int64_t i = 0; i < cnt; ++i) x[idx++] = rice(br, param);
            }
        }
        if (idx != blocksize) return false;
        // predict
        if (kind == FIXED) {
            switch (order) {
                case 0: break;
                case 1:
                    for (int i = 1; i < blocksize; ++i) x[i] += x[i - 1];
                    break;
                case 2:
                    for (int i = 2; i < blocksize; ++i)
                        x[i] += 2 * x[i - 1] - x[i - 2];
                    break;
                case 3:
                    for (int i = 3; i < blocksize; ++i)
                        x[i] += 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3];
                    break;
                case 4:
                    for (int i = 4; i < blocksize; ++i)
                        x[i] += 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3]
                                - x[i - 4];
                    break;
            }
        } else {  // LPC
            for (int i = order; i < blocksize; ++i) {
                int64_t acc = 0;
                for (int j = 0; j < order; ++j)
                    acc += coefs[j] * x[i - 1 - j];
                x[i] += acc >> shift;
            }
        }
    }
    if (wasted)
        for (int i = 0; i < blocksize; ++i) x[i] <<= wasted;
    return !br.error;
}

inline int64_t utf8_number(BitReader& br) {
    uint64_t b0 = br.bits(8);
    int extra = 0;
    uint64_t v;
    if ((b0 & 0x80) == 0) return (int64_t)b0;
    else if ((b0 & 0xE0) == 0xC0) { v = b0 & 0x1F; extra = 1; }
    else if ((b0 & 0xF0) == 0xE0) { v = b0 & 0x0F; extra = 2; }
    else if ((b0 & 0xF8) == 0xF0) { v = b0 & 0x07; extra = 3; }
    else if ((b0 & 0xFC) == 0xF8) { v = b0 & 0x03; extra = 4; }
    else if ((b0 & 0xFE) == 0xFC) { v = b0 & 0x01; extra = 5; }
    else if (b0 == 0xFE) { v = 0; extra = 6; }
    else return -1;
    for (int i = 0; i < extra; ++i) v = (v << 6) | (br.bits(8) & 0x3F);
    return (int64_t)v;
}

}  // namespace flac

// Decode a FLAC stream. out receives interleaved int32 samples (already
// shifted so full scale is the stream's bps); meta receives
// {channels, sample_rate, bps, total_samples_per_channel}. Pass
// out == nullptr to only read STREAMINFO. Returns samples decoded per
// channel, or -1 on error.
int64_t adaa_flac_decode(const uint8_t* data, int64_t nbytes,
                         int32_t* out, int64_t out_capacity,
                         int64_t* meta) {
    using namespace flac;
    if (nbytes < 42 || memcmp(data, "fLaC", 4) != 0) return -1;
    BitReader br{data, nbytes};
    br.bytepos = 4;
    int channels = 0, bps = 0;
    int64_t srate = 0, total = 0;
    bool have_info = false;
    // metadata blocks
    for (;;) {
        int last = (int)br.bits(1);
        int type = (int)br.bits(7);
        int64_t len = (int64_t)br.bits(24);
        if (br.error) return -1;
        if (type == 0 && len >= 34) {
            br.bits(16); br.bits(16);  // min/max blocksize
            br.bits(24); br.bits(24);  // min/max framesize
            srate = (int64_t)br.bits(20);
            channels = (int)br.bits(3) + 1;
            bps = (int)br.bits(5) + 1;
            total = (int64_t)br.bits(36);
            br.bytepos += len - 18;  // skip md5 + any extension
            have_info = true;
        } else {
            br.bytepos += len;
        }
        if (last) break;
        if (br.eof()) return -1;
    }
    // Only mono/stereo layouts are implemented (the decode loop below
    // allocates at most two channel buffers); reject anything else up
    // front rather than decoding c>=1 subframes into an empty buffer.
    if (!have_info || channels < 1 || channels > 2) return -1;
    if (meta) {
        meta[0] = channels; meta[1] = srate; meta[2] = bps; meta[3] = total;
    }
    // out == nullptr: metadata pass. If STREAMINFO carries the total we
    // return it directly; otherwise fall through into the frame loop in
    // counting-only mode (decode, don't store) so the caller gets an
    // exact capacity instead of guessing a compression ratio.
    if (!out && total > 0) return total;

    std::vector<int64_t> ch0, ch1;
    int64_t written = 0;  // per channel
    while (!br.eof() && !br.error) {
        if (total > 0 && written >= total) break;
        // frame header
        if (br.bits(14) != 0x3FFE) break;  // sync (also EOF padding)
        br.bits(1);  // reserved
        br.bits(1);  // blocking strategy
        int bs_code = (int)br.bits(4);
        int sr_code = (int)br.bits(4);
        int ch_code = (int)br.bits(4);
        int ss_code = (int)br.bits(3);
        br.bits(1);  // reserved
        if (utf8_number(br) < 0) return -1;
        int blocksize;
        if (bs_code == 1) blocksize = 192;
        else if (bs_code >= 2 && bs_code <= 5) blocksize = 576 << (bs_code - 2);
        else if (bs_code == 6) blocksize = (int)br.bits(8) + 1;
        else if (bs_code == 7) blocksize = (int)br.bits(16) + 1;
        else if (bs_code >= 8) blocksize = 256 << (bs_code - 8);
        else return -1;
        if (sr_code == 12) br.bits(8);
        else if (sr_code == 13 || sr_code == 14) br.bits(16);
        int fbps = bps;
        switch (ss_code) {
            case 0: break;
            case 1: fbps = 8; break;
            case 2: fbps = 12; break;
            case 4: fbps = 16; break;
            case 5: fbps = 20; break;
            case 6: fbps = 24; break;
            case 7: fbps = 32; break;
            default: return -1;
        }
        br.bits(8);  // header CRC-8 (unverified)

        int nch = channels;
        int decor = 0;  // 0 none, 1 left/side, 2 right/side, 3 mid/side
        if (ch_code <= 7) nch = ch_code + 1;
        else if (ch_code == 8) { nch = 2; decor = 1; }
        else if (ch_code == 9) { nch = 2; decor = 2; }
        else if (ch_code == 10) { nch = 2; decor = 3; }
        else return -1;
        if (nch != channels) return -1;

        ch0.assign(blocksize, 0);
        if (nch == 2) ch1.assign(blocksize, 0);
        for (int c = 0; c < nch; ++c) {
            int sb_bps = fbps;
            if ((decor == 1 && c == 1) || (decor == 2 && c == 0) ||
                (decor == 3 && c == 1))
                sb_bps += 1;  // side channel
            if (!subframe(br, c == 0 ? ch0.data() : ch1.data(), blocksize,
                          sb_bps))
                return -1;
        }
        br.align();
        br.bits(16);  // frame CRC-16 (unverified)
        if (br.error) return -1;

        // undo stereo decorrelation
        if (decor == 1) {  // left/side: right = left - side
            for (int i = 0; i < blocksize; ++i) ch1[i] = ch0[i] - ch1[i];
        } else if (decor == 2) {  // right/side: left = right + side
            for (int i = 0; i < blocksize; ++i) ch0[i] = ch1[i] + ch0[i];
        } else if (decor == 3) {  // mid/side
            for (int i = 0; i < blocksize; ++i) {
                int64_t mid = (ch0[i] << 1) | (ch1[i] & 1);
                int64_t side = ch1[i];
                ch0[i] = (mid + side) >> 1;
                ch1[i] = (mid - side) >> 1;
            }
        }

        int64_t take = blocksize;
        if (total > 0 && written + take > total) take = total - written;
        if (out) {
            if ((written + take) * nch > out_capacity) return -1;
            for (int64_t i = 0; i < take; ++i) {
                out[(written + i) * nch] = (int32_t)ch0[i];
                if (nch == 2) out[(written + i) * nch + 1] = (int32_t)ch1[i];
            }
        }
        written += take;
    }
    return written;
}

void adaa_repeat_pad(const float* in, int64_t n, float* out, int64_t cut) {
    if (n >= cut) {
        std::memcpy(out, in, cut * sizeof(float));
        return;
    }
    int64_t off = 0;
    while (off < cut) {
        int64_t chunk = std::min(n, cut - off);
        std::memcpy(out + off, in, chunk * sizeof(float));
        off += chunk;
    }
}

}  // extern "C"
