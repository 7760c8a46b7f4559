"""Framework tunables.

Mirrors the user-visible numeric contracts of the reference's
include/constants.h (every tunable in one place, constants.h:1-276), with
device-appropriate values where the reference's were CPU/thread-pipeline
artifacts.
"""

# ---- Block / streaming geometry --------------------------------------------
# Reference: 512 chunks x 16384 samples (constants.h:110,123).  Here a
# "chunk" is one device block; the host keeps a small bounded queue of
# in-flight blocks instead of a 512-deep pool.
DEFAULT_BLOCK_SIZE = 16384          # complex frames per device block (target)
MAX_BLOCK_SIZE = 1 << 20            # hard cap (constants.h:252 analog)
HOST_QUEUE_DEPTH = 8                # in-flight host->device blocks
WRITER_QUEUE_DEPTH = 16             # in-flight device->host output blocks

# ---- DSP numeric contracts (same as reference) ------------------------------
RESAMPLER_ATTENUATION_DB = 60.0     # constants.h:137 (msresamp 60 dB)
DC_BLOCK_CUTOFF_HZ = 10.0           # constants.h:149
FILTER_MIN_TAPS = 21                # filter.c:195 (forced odd, min 21)
FILTER_MAX_CHAIN = 5                # constants.h:248 (up to 5 chained filters)
FILTER_NORM_FREQ_POINTS = 2048      # filter.c:272-299 peak-|H| scan grid
FREQ_SHIFT_SANITY_FACTOR = 5.0      # constants.h:247 (|shift| <= 5*rate)
RESAMPLE_RATIO_MIN = 0.001          # constants.h:245
RESAMPLE_RATIO_MAX = 1000.0         # constants.h:246

# ---- I/Q imbalance estimation (iq_correct.c / constants.h:157-162) ----------
IQ_FFT_SIZE = 1024
IQ_UPDATE_INTERVAL_SEC = 0.5
IQ_EST_STEP = 1e-4                  # hill-climb step in the reference
IQ_SMOOTHING = 0.05                 # EMA factor into active correction
IQ_POWER_GATE_DB = 20.0             # peak-to-avg gate
IQ_SPECTRUM_FLOOR_DB = -80.0        # bins below floor ignored in utility
IQ_BAND_LO = 0.05                   # utility band: 5%..95% of bins
IQ_BAND_HI = 0.95
# Redesign: deterministic zooming grid search instead of 25 random
# passes (iq_correct.c:191-201).  3 rounds x 9x9 grid spans +-8*step then
# zooms 4x per round; resolution ~= step/8.
IQ_GRID_POINTS = 9
IQ_GRID_ROUNDS = 3
IQ_GRID_SPAN = 8.0                  # initial half-span in units of IQ_EST_STEP

# ---- AGC profiles (agc.c / constants.h:169-192) ------------------------------
AGC_TARGET = 0.5
AGC_BW_DX = 1e-4
AGC_BW_LOCAL = 1e-2
AGC_DIGITAL_TARGET = 0.9          # agc.c digital default target
AGC_DIGITAL_SCAN_SEC = 2.0          # peak-scan window before locking
AGC_DIGITAL_HANG_SEC = 4.0          # hang time after a clip ratchet
AGC_DIGITAL_CLIP_RATCHET = 0.99     # on clip: gain -> 0.99/peak
AGC_DIGITAL_CREEP = 1.0005          # gain creep per block while under target
AGC_DIGITAL_CREEP_THRESH = 0.75     # creep while peak < 75% of target
AGC_SEGMENT = 128                   # samples per gain-update segment

# ---- Resampler framing -------------------------------------------------------
RESAMP_SEMILENGTH = 16              # taps per output = 2*semilength (matmul form makes longer kernels ~free; +4 dB margin)
RESAMP_FC_FACTOR = 0.90             # cutoff margin (fraction of min Nyquist)
RESAMP_MAX_DENOM = 65536            # Farey limit when rationalizing ratios
RESAMP_STAGE_MAX = 512              # max p_i/q_i factor per cascade stage
RESAMP_GROUP_CAP = 256              # cap on g*max(p,q): bounds stage matmul width

# ---- Watchdog / runtime ------------------------------------------------------
WATCHDOG_POLL_SEC = 2.0             # constants.h:270
WATCHDOG_STALE_SEC = 8.0            # constants.h:274
PROGRESS_INTERVAL_SEC = 1.0         # main.c progress cadence
BACKPRESSURE_HIGH_WATER = 0.95      # constants.h:98

# ---- SDR defaults ------------------------------------------------------------
RTLSDR_DEFAULT_RATE = 2_400_000     # constants.h:200
BANDED_STRIDE_CAP = 256             # FIR toeplitz-matmul output group width
PIPELINE_DEPTH = 4                  # host<->device in-flight steps (runtime.py)
FUSE_MAX_TAPS = 256                 # FIR->resampler fusion cap (chain.py)
FFT_MIN_BLOCK = 2048               # auto overlap-save block floor
