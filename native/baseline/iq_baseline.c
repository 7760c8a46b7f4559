/* iq_baseline — honest multi-threaded CPU baseline for BASELINE config #1.
 *
 * The reference binary cannot be built in this image (liquid-dsp and
 * libsndfile are absent and there is no network), so this standalone C
 * program implements the SAME signal chain the reference runs for
 * config #1 — cs16 -> DC block -> NCO shift -> polyphase rational
 * resample 2.048e6 -> 1.488375e6 (Kaiser, 60 dB) -> 55-tap FIR low-pass
 * -> cs16 — with the reference's build regime (-O3 -march=native
 * -ffast-math, see /root/reference/CMakeLists.txt:721-742) and pthread
 * data-parallelism standing in for its 5-8 stage threads.  It measures
 * steady-state input samples/s; the repo's vs_baseline numbers divide by
 * this.  DSP structure mirrors the contracts in SURVEY.md section 2b,
 * not any liquid-dsp source.
 *
 * build: gcc -O3 -march=native -ffast-math -o iq_baseline iq_baseline.c -lm -lpthread
 * usage: ./iq_baseline [n_frames] [n_threads] [seconds]
 */

#define _GNU_SOURCE
#include <math.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#define RATE_IN  2048000.0
#define RATE_OUT 1488375.0
#define P_UP     11907           /* 1488375/2048000 reduced */
#define Q_DN     16384
#define SEMILEN  16              /* matches ops/resample.py RESAMP_SEMILENGTH */
#define K_TAPS   (2 * SEMILEN)
#define ATTEN_DB 60.0
#define FIR_TAPS 55              /* 400 kHz lowpass at the output rate */
#define SHIFT_HZ (-100000.0)
#define DC_CUT_HZ 10.0

static double bessel_i0(double x) {
    double s = 1.0, t = 1.0;
    for (int k = 1; k < 64; k++) {
        t *= (x / (2.0 * k)) * (x / (2.0 * k));
        s += t;
        if (t < 1e-18 * s) break;
    }
    return s;
}

static double kaiser_beta(double atten_db) {
    if (atten_db > 50.0) return 0.1102 * (atten_db - 8.7);
    if (atten_db >= 21.0)
        return 0.5842 * pow(atten_db - 21.0, 0.4) + 0.07886 * (atten_db - 21.0);
    return 0.0;
}

/* Kaiser-windowed sinc at real offset t (input-sample units) */
static double kern(double t, double fc, double semilen, double beta) {
    if (fabs(t) > semilen) return 0.0;
    double warg = 1.0 - (t / semilen) * (t / semilen);
    double w = bessel_i0(beta * sqrt(warg > 0 ? warg : 0)) / bessel_i0(beta);
    double x = 2.0 * fc * t;
    double g = (fabs(x) < 1e-12) ? 1.0 : sin(M_PI * x) / (M_PI * x);
    return 2.0 * fc * g * w;
}

/* ---- exact per-phase polyphase table (P_UP fractional phases) ---------- */
static float *phase_w;           /* [P_UP][K_TAPS] */

static void build_phase_table(void) {
    double beta = kaiser_beta(ATTEN_DB);
    double fc = 0.5 * ((double)P_UP / Q_DN) * 0.92;
    phase_w = malloc((size_t)P_UP * K_TAPS * sizeof(float));
    for (int p = 0; p < P_UP; p++) {
        /* output m looks up row ph = (m*Q) mod P, whose fractional delay
         * is tau - floor(tau) = ph / P */
        double frac = (double)p / P_UP;
        double sum = 0.0;
        double wrow[K_TAPS];
        for (int k = 0; k < K_TAPS; k++) {
            double t = frac + (SEMILEN - 1) - k;
            wrow[k] = kern(t, fc, SEMILEN, beta);
            sum += wrow[k];
        }
        for (int k = 0; k < K_TAPS; k++)
            phase_w[(size_t)p * K_TAPS + k] = (float)(wrow[k] / sum);
    }
}

static float fir_taps[FIR_TAPS];
static const float *g_fir = fir_taps;    /* active post-filter */
static int g_ntaps = FIR_TAPS;

static void kaiser_lowpass(float *dst, int ntaps, double fc) {
    double beta = kaiser_beta(ATTEN_DB);
    double sum = 0.0;
    int m = ntaps / 2;
    for (int k = 0; k < ntaps; k++) {
        double t = k - m;
        double warg = 1.0 - (t / (m + 1.0)) * (t / (m + 1.0));
        double w = bessel_i0(beta * sqrt(warg > 0 ? warg : 0)) / bessel_i0(beta);
        double x = 2.0 * fc * t;
        double g = (fabs(x) < 1e-12) ? 1.0 : sin(M_PI * x) / (M_PI * x);
        dst[k] = (float)(2.0 * fc * g * w);
        sum += dst[k];
    }
    for (int k = 0; k < ntaps; k++) dst[k] /= (float)sum;
}

static void build_fir(void) {
    kaiser_lowpass(fir_taps, FIR_TAPS, 400000.0 / RATE_OUT);
}

/* symmetric DC notch (stop |f| <= edge_hz) by spectral inversion of a
 * unity-DC Kaiser low-pass (filter.c:94-99 semantics) */
static void build_notch(int ntaps, double edge_hz) {
    float *t = malloc((size_t)ntaps * sizeof(float));
    kaiser_lowpass(t, ntaps, edge_hz / RATE_OUT);
    for (int k = 0; k < ntaps; k++) t[k] = -t[k];
    t[ntaps / 2] += 1.0f;
    g_fir = t;
    g_ntaps = ntaps;
}

/* ------------------------------- chain ---------------------------------- */

typedef struct {
    const float *xi, *xq;        /* resampler input (with K-1 history) */
    float *yi, *yq;              /* resampler output */
    long m0, m1;                 /* output span */
} span_t;

static void *resample_span(void *arg) {
    span_t *s = arg;
    for (long m = s->m0; m < s->m1; m++) {
        /* tau = m*Q/P; window starts at floor(tau) - SEMILEN + 1 (+hist) */
        long num = m * (long)Q_DN;
        long nbase = num / P_UP;
        int  ph = (int)(num % P_UP);
        const float *w = &phase_w[(size_t)ph * K_TAPS];
        const float *pi = s->xi + nbase;     /* history offset pre-applied */
        const float *pq = s->xq + nbase;
        float ai = 0.f, aq = 0.f;
        for (int k = 0; k < K_TAPS; k++) {
            ai += pi[k] * w[k];
            aq += pq[k] * w[k];
        }
        s->yi[m] = ai;
        s->yq[m] = aq;
    }
    return NULL;
}

typedef struct {
    const float *xi, *xq;        /* FIR input (with FIR_TAPS-1 history) */
    int16_t *out;                /* interleaved cs16 */
    long m0, m1;
} fspan_t;

static void *fir_span(void *arg) {
    fspan_t *s = arg;
    for (long m = s->m0; m < s->m1; m++) {
        const float *pi = s->xi + m;
        const float *pq = s->xq + m;
        float ai = 0.f, aq = 0.f;
        for (int k = 0; k < g_ntaps; k++) {
            ai += pi[k] * g_fir[k];
            aq += pq[k] * g_fir[k];
        }
        /* round-half-away + clamp (sample_convert.c contract) */
        float si = ai * 32768.0f, sq = aq * 32768.0f;
        si = si >= 0 ? si + 0.5f : si - 0.5f;
        sq = sq >= 0 ? sq + 0.5f : sq - 0.5f;
        if (si > 32767.f) si = 32767.f;
        if (si < -32768.f) si = -32768.f;
        if (sq > 32767.f) sq = 32767.f;
        if (sq < -32768.f) sq = -32768.f;
        s->out[2 * m] = (int16_t)si;
        s->out[2 * m + 1] = (int16_t)sq;
    }
    return NULL;
}

static double now_sec(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

/* ---- standalone AGC golden mode (cross-implementation oracle) -----------
 *
 * "agc:<profile>:<gainfile>:<outfile>" feeds a deterministic AM tone at
 * the OUTPUT rate through the reference AGC contract (SURVEY.md 2b /
 * agc.c:38-68, 117-221) implemented the reference's way — a per-SAMPLE
 * one-pole RMS loop for dx/local (the JAX chain aggregates it at
 * AGC_SEGMENT granularity, ops/agc.py) and the per-block peak-lock
 * state machine for digital — then writes a float32 per-sample gain
 * trace plus the cs16 output so tests/test_c_golden.py can bound the
 * segment-aggregation error against this independent implementation. */

#define AGC_RMS_TARGET 0.5
#define AGC_BW_DX 1e-4
#define AGC_BW_LOCAL 1e-2
#define AGC_DIG_TARGET 0.9
#define AGC_DIG_SCAN_SEC 2.0
#define AGC_DIG_HANG_SEC 4.0
#define AGC_DIG_RATCHET 0.99
#define AGC_DIG_CREEP 1.0005
#define AGC_DIG_CREEP_THRESH 0.75
#define AGC_BLOCK 16384          /* digital state machine granularity */

static int run_agc_golden(long n, const char *spec) {
    char buf[512];
    strncpy(buf, spec, sizeof(buf) - 1);
    buf[sizeof(buf) - 1] = 0;
    char *c1 = strchr(buf, ':');
    if (!c1) return 1;
    *c1 = 0;
    char *c2 = strchr(c1 + 1, ':');
    if (!c2) return 1;
    *c2 = 0;
    const char *profile = buf, *gain_path = c1 + 1, *out_path = c2 + 1;

    /* deterministic AM tone, reproducible bit-for-bit from Python:
     * env = 0.6*(1 + 0.5 sin(2pi*1000 i/Fs)) x a step profile (x1 to 4 s,
     * x1.8 to 5 s — forces a clip ratchet after digital lock — then x0.2 —
     * weak, so creep engages after the 4 s hang), carrier 200 kHz,
     * cs16-quantized then renormalized so both sides see identical floats */
    float *xi = malloc((size_t)n * sizeof(float));
    float *xq = malloc((size_t)n * sizeof(float));
    long s2 = (long)(4.0 * RATE_OUT), s3 = (long)(5.0 * RATE_OUT);
    for (long i = 0; i < n; i++) {
        double scale = i < s2 ? 1.0 : (i < s3 ? 1.8 : 0.2);
        double env = scale * 0.6
                     * (1.0 + 0.5 * sin(2.0 * M_PI * 1000.0 * i / RATE_OUT));
        double ph = 2.0 * M_PI * 200000.0 * i / RATE_OUT;
        xi[i] = (float)(lround(32767.0 * env * cos(ph)) / 32768.0);
        xq[i] = (float)(lround(32767.0 * env * sin(ph)) / 32768.0);
    }

    float *gain = malloc((size_t)n * sizeof(float));
    int16_t *out = malloc((size_t)n * 2 * sizeof(int16_t));

    if (strcmp(profile, "dx") == 0 || strcmp(profile, "local") == 0) {
        /* liquid agc_crcf semantics: y = x*g; e2' = (1-bw)e2 + bw|y|^2;
         * g *= exp(-0.5 bw ln(e2'/t^2))  (agc.c:38-68, bw 1e-4 / 1e-2,
         * target 0.5, gain init 1.0) */
        float bw = (float)(strcmp(profile, "dx") == 0 ? AGC_BW_DX
                                                      : AGC_BW_LOCAL);
        float g = 1.0f, e2 = 0.0f;
        float t2 = (float)(AGC_RMS_TARGET * AGC_RMS_TARGET);
        for (long i = 0; i < n; i++) {
            float yi_ = xi[i] * g, yq_ = xq[i] * g;
            e2 = (1.0f - bw) * e2 + bw * (yi_ * yi_ + yq_ * yq_);
            float e = e2 > 1e-16f ? e2 : 1e-16f;
            g *= expf(-0.5f * bw * logf(e / t2));
            if (g < 1e-6f) g = 1e-6f;
            if (g > 1e6f) g = 1e6f;
            gain[i] = g;
            float si = yi_ * 32768.0f, sq = yq_ * 32768.0f;
            si = si >= 0 ? si + 0.5f : si - 0.5f;
            sq = sq >= 0 ? sq + 0.5f : sq - 0.5f;
            if (si > 32767.f) si = 32767.f;
            if (si < -32768.f) si = -32768.f;
            if (sq > 32767.f) sq = 32767.f;
            if (sq < -32768.f) sq = -32768.f;
            out[2 * i] = (int16_t)si;
            out[2 * i + 1] = (int16_t)sq;
        }
    } else if (strcmp(profile, "digital") == 0) {
        /* block-granular peak-lock state machine (agc.c:117-221 with
         * sample-time windows, matching ops/agc.py digital_update) */
        float g = 1.0f, peak_mem = 0.05f;
        long samples_seen = 0, weak_run = 0;
        int locked = 0;
        long lock_samples = (long)(AGC_DIG_SCAN_SEC * RATE_OUT);
        long hang_samples = (long)(AGC_DIG_HANG_SEC * RATE_OUT);
        for (long b0 = 0; b0 < n; b0 += AGC_BLOCK) {
            long bn = n - b0 < AGC_BLOCK ? n - b0 : AGC_BLOCK;
            float pk2 = 0.0f;
            for (long i = b0; i < b0 + bn; i++) {
                float p = xi[i] * xi[i] + xq[i] * xq[i];
                if (p > pk2) pk2 = p;
            }
            float block_peak = sqrtf(pk2);
            float gain_out;
            if (!locked) {
                if (block_peak > peak_mem) peak_mem = block_peak;
                float safe = peak_mem > 1e-4f ? peak_mem : 1e-4f;
                gain_out = (float)AGC_DIG_TARGET / safe;
                if (samples_seen > lock_samples) {
                    locked = 1;
                    g = gain_out;
                }
                weak_run = 0;
            } else {
                float out_peak = block_peak * g;
                int clip = out_peak > 1.0f;
                int strong = out_peak > (float)(AGC_DIG_TARGET
                                                * AGC_DIG_CREEP_THRESH);
                int creep = !clip && !strong && weak_run > hang_samples;
                if (clip)
                    g = (float)AGC_DIG_RATCHET
                        / (block_peak > 1e-9f ? block_peak : 1e-9f);
                else if (creep)
                    g *= (float)AGC_DIG_CREEP;
                weak_run = (clip || strong) ? 0 : weak_run + bn;
                gain_out = g;
            }
            samples_seen += bn;
            for (long i = b0; i < b0 + bn; i++) {
                gain[i] = gain_out;
                float si = xi[i] * gain_out * 32768.0f;
                float sq = xq[i] * gain_out * 32768.0f;
                si = si >= 0 ? si + 0.5f : si - 0.5f;
                sq = sq >= 0 ? sq + 0.5f : sq - 0.5f;
                if (si > 32767.f) si = 32767.f;
                if (si < -32768.f) si = -32768.f;
                if (sq > 32767.f) sq = 32767.f;
                if (sq < -32768.f) sq = -32768.f;
                out[2 * i] = (int16_t)si;
                out[2 * i + 1] = (int16_t)sq;
            }
        }
    } else {
        fprintf(stderr, "unknown agc profile %s\n", profile);
        return 1;
    }

    FILE *fg = fopen(gain_path, "wb");
    fwrite(gain, sizeof(float), (size_t)n, fg);
    fclose(fg);
    FILE *fo = fopen(out_path, "wb");
    fwrite(out, sizeof(int16_t), (size_t)n * 2, fo);
    fclose(fo);
    printf("{\"mode\": \"agc\", \"profile\": \"%s\", \"n\": %ld}\n",
           profile, n);
    return 0;
}

int main(int argc, char **argv) {
    long n = argc > 1 ? atol(argv[1]) : 1 << 21;
    int nthreads = argc > 2 ? atoi(argv[2]) : 4;
    double run_for = argc > 3 ? atof(argv[3]) : 5.0;
    long m_out = n * (long)P_UP / Q_DN;

    build_phase_table();
    build_fir();

    /* 4th arg "tone:<hz>:<outfile>" switches to a quality-check run: feed a
     * complex tone, write one pass of cs16 output for SNR verification.
     * "notch:<hzA>:<hzB>:<outfile>" instead feeds TWO tones and swaps the
     * 55-tap low-pass for a 1101-tap spectral-inversion DC notch
     * (|f| <= 5 kHz stopped, matching the repo's stop-range center 0
     * width 10 kHz) — the golden partner for the DFT-engine path. */
    const char *tone_spec = argc > 4 ? argv[4] : NULL;
    if (tone_spec && strncmp(tone_spec, "agc:", 4) == 0)
        return run_agc_golden(n, tone_spec + 4);
    double tone_hz = 0.0, tone_hz_b = 0.0;
    int two_tone = 0, cu8_input = 0;
    const char *tone_out = NULL;
    char tone_buf[256];
    /* "cu8tone:<hz>:<outfile>": BASELINE config #3's shape — cu8 input
     * ((x-127.5)/128 normalizer, sample_convert.c:135-146) through the
     * same dc+resample+lowpass chain (the 0-centered pass-range is a
     * symmetric real low-pass) */
    if (tone_spec && strncmp(tone_spec, "cu8tone:", 8) == 0) {
        cu8_input = 1;
        tone_spec += 3;                   /* -> "tone:..." parse below */
    }
    if (tone_spec && strncmp(tone_spec, "tone:", 5) == 0) {
        strncpy(tone_buf, tone_spec + 5, sizeof(tone_buf) - 1);
        tone_buf[sizeof(tone_buf) - 1] = 0;
        char *colon = strchr(tone_buf, ':');
        if (colon) { *colon = 0; tone_out = colon + 1; }
        tone_hz = atof(tone_buf);
    } else if (tone_spec && strncmp(tone_spec, "notch:", 6) == 0) {
        strncpy(tone_buf, tone_spec + 6, sizeof(tone_buf) - 1);
        tone_buf[sizeof(tone_buf) - 1] = 0;
        char *c1 = strchr(tone_buf, ':');
        if (c1) {
            *c1 = 0;
            char *c2 = strchr(c1 + 1, ':');
            if (c2) { *c2 = 0; tone_out = c2 + 1; }
            tone_hz_b = atof(c1 + 1);
        }
        tone_hz = atof(tone_buf);
        two_tone = 1;
        build_notch(1101, 5000.0);
    }

    int16_t *raw = malloc((size_t)n * 2 * sizeof(int16_t));
    if (tone_out) {
        for (long i = 0; i < n; i++) {
            double pa = 2.0 * M_PI * tone_hz * i / RATE_IN;
            double ci = 0.5 * cos(pa), cq = 0.5 * sin(pa);
            if (two_tone) {
                double pb = 2.0 * M_PI * tone_hz_b * i / RATE_IN;
                ci = 0.25 * cos(pa) + 0.25 * cos(pb);
                cq = 0.25 * sin(pa) + 0.25 * sin(pb);
            }
            if (cu8_input) {
                raw[2 * i] = (int16_t)lround(127.5 + 127.0 * ci);
                raw[2 * i + 1] = (int16_t)lround(127.5 + 127.0 * cq);
            } else {
                raw[2 * i] = (int16_t)lround(32767.0 * ci);
                raw[2 * i + 1] = (int16_t)lround(32767.0 * cq);
            }
        }
        run_for = 0.0;                       /* single pass */
    } else {
        srand(12345);
        for (long i = 0; i < 2 * n; i++)
            raw[i] = (int16_t)((rand() % 16384) - 8192);
    }

    float *xi = calloc(n + K_TAPS, sizeof(float));
    float *xq = calloc(n + K_TAPS, sizeof(float));
    float *yi = calloc(m_out + g_ntaps, sizeof(float));
    float *yq = calloc(m_out + g_ntaps, sizeof(float));
    int16_t *out = malloc((size_t)m_out * 2 * sizeof(int16_t));
    pthread_t th[64];
    span_t sp[64];
    fspan_t fs[64];
    if (nthreads > 64) nthreads = 64;

    double alpha = 2.0 * M_PI * DC_CUT_HZ / RATE_IN;
    float a = (float)(1.0 - alpha);
    double dphi = 2.0 * M_PI * SHIFT_HZ / RATE_IN;
    float cs = (float)cos(dphi), sn = (float)sin(dphi);

    long reps = 0;
    double t0 = now_sec(), t1;
    do {
        /* convert + DC block + NCO shift: sequential recurrences, one pass
         * (pre_processor.c chain order) */
        float di = 0.f, dq = 0.f, pi_ = 0.f, pq_ = 0.f;
        float oi = 1.f, oq = 0.f;        /* NCO phasor */
        float *vi = xi + K_TAPS - 1, *vq = xq + K_TAPS - 1;
        for (long i = 0; i < n; i++) {
            float ci, cq;
            if (cu8_input) {               /* (x - 127.5) / 128 */
                ci = (raw[2 * i] - 127.5f) * (1.0f / 128.0f);
                cq = (raw[2 * i + 1] - 127.5f) * (1.0f / 128.0f);
            } else {
                ci = raw[2 * i] * (1.0f / 32768.0f);
                cq = raw[2 * i + 1] * (1.0f / 32768.0f);
            }
            /* DC IIR y = x - x1 + a*y1 */
            float wi = ci - pi_ + a * di;
            float wq = cq - pq_ + a * dq;
            pi_ = ci; pq_ = cq; di = wi; dq = wq;
            /* mix */
            vi[i] = wi * oi - wq * oq;
            vq[i] = wi * oq + wq * oi;
            float noi = oi * cs - oq * sn;
            oq = oi * sn + oq * cs;
            oi = noi;
            if ((i & 1023) == 1023) {            /* renormalize phasor */
                float r = 1.0f / sqrtf(oi * oi + oq * oq);
                oi *= r; oq *= r;
            }
        }
        /* polyphase resample, data-parallel over output spans */
        for (int t = 0; t < nthreads; t++) {
            sp[t] = (span_t){xi, xq, yi + g_ntaps - 1, yq + g_ntaps - 1,
                             m_out * t / nthreads, m_out * (t + 1) / nthreads};
            pthread_create(&th[t], NULL, resample_span, &sp[t]);
        }
        for (int t = 0; t < nthreads; t++) pthread_join(th[t], NULL);
        /* FIR low-pass + cs16 quantize, data-parallel */
        for (int t = 0; t < nthreads; t++) {
            fs[t] = (fspan_t){yi, yq, out,
                              m_out * t / nthreads, m_out * (t + 1) / nthreads};
            pthread_create(&th[t], NULL, fir_span, &fs[t]);
        }
        for (int t = 0; t < nthreads; t++) pthread_join(th[t], NULL);
        reps++;
        t1 = now_sec();
    } while (t1 - t0 < run_for);

    if (tone_out) {
        FILE *f = fopen(tone_out, "wb");
        fwrite(out, sizeof(int16_t), (size_t)m_out * 2, f);
        fclose(f);
    }
    double msps = (double)n * reps / (t1 - t0) / 1e6;
    /* checksum defeats dead-code elimination */
    long chk = 0;
    for (long i = 0; i < 2 * m_out; i += 997) chk += out[i];
    fprintf(stderr, "chk=%ld reps=%ld\n", chk, reps);
    printf("{\"metric\": \"cpu_baseline_msps\", \"value\": %.3f, "
           "\"unit\": \"Msamples/s in\", \"threads\": %d, "
           "\"frames\": %ld, \"chain\": \"cs16 dc+shift+resample(11907/16384)+lowpass55+cs16\"}\n",
           msps, nthreads, n);
    return 0;
}
