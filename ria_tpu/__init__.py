"""ria_tpu — an accelerator-native HF software-modem framework.

A from-scratch JAX/XLA re-design of the capabilities of the RIA HF
modem reference (adaptive HF data transfer from -14 dB to 30+ dB SNR):

- DSP substrate: batched FIR/overlap-save, polyphase resampling, NCO mixing,
  FFT-based Hilbert transforms (``ria_tpu.dsp``).
- FEC: 648-bit LDPC (R1/4..R5/6) with a bit-compatible deterministic parity
  matrix, batched normalized min-sum belief propagation as batched matmuls,
  interleavers, HARQ chase combining (``ria_tpu.fec``).
- Synchronization: dual linear-FM chirp, Zadoff-Chu root bank, CSS and
  Schmidl-Cox, all as batched FFT correlation (``ria_tpu.sync``).
- Waveforms: MC-DPSK (mixer-bank einsum demod), OFDM (1024-pt, CP 96,
  pilot-assisted MMSE equalization), OTFS, MFSK (``ria_tpu.wave``).
- PHY pipelines: frame-v2 wire format, TX encoder and RX decoder as pure
  batched array programs (``ria_tpu.phy``).
- Protocol: ARQ (stop-and-wait + selective repeat), connection management,
  adaptive waveform/rate selection (``ria_tpu.protocol``).
- Simulation: jittable seeded Watterson (ITU-R F.1487) channel
  (``ria_tpu.sim``).
- Parallel scale-out: channel/time-block sharding over a device mesh
  (``ria_tpu.parallel``).

Everything inside the signal path is jittable, statically-shaped and batched;
host-side Python orchestrates framing and protocol state.
"""

__version__ = "0.1.0"

SAMPLE_RATE = 48000.0
