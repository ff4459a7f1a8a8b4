"""sot_tpu_torch — the PyTorch/CUDA port of ``sot_tpu`` for NVIDIA Hopper.

The JAX package ``sot_tpu`` is the reference; this package mirrors its layout
module for module (``sot_tpu_torch/ops/cqt.py`` <-> ``sot_tpu/ops/cqt.py``)
and imports nothing of it, nor of JAX.

Layer map (this slice: the serving path, ``training.trainer.predict``):
  ops/numerics, ops/windows     L0  safe math, pitch maps, windows
  ops/{cqt,resample,scan,       L1  DSP ops (plain PyTorch)
       oscillator,stft}
  ops/kernels + csrc/           --  hand-written CUDA kernels (sm_90a):
                                    CQT projection, synth forward
  features                      L2  CQT feature extractor
  models/                       L3  PESTO encoder + frozen sinusoidal synth
  training/trainer              L5  build_modules / forward / predict
  configs, cli                  L6  experiment registry + ``predict`` CLI
  data                          L7  synthetic harmonic-sinusoid clips
  convert                       --  flax param tree <-> torch state dict
  device                        --  device resolution + precision policy
"""
