"""sot_tpu_torch — the PyTorch/CUDA port of ``sot_tpu`` for NVIDIA Hopper.

The JAX package ``sot_tpu`` is the reference; this package mirrors its layout
module for module (``sot_tpu_torch/ops/cqt.py`` <-> ``sot_tpu/ops/cqt.py``)
and imports nothing of it, nor of JAX.

Layer map:
  ops/numerics, ops/windows     L0  safe math, pitch maps, windows
  ops/{cqt,resample,scan,       L1  DSP ops (plain PyTorch)
       oscillator,stft,fir,
       wasserstein}
  ops/kernels + csrc/           --  hand-written CUDA kernels (sm_90a):
                                    the eleven TPU kernels' counterparts
  features, losses, metrics     L2  CQT/STFT features, MSS and SOT losses,
                                    the metric suite and pitch corrections
  models/                       L3  PESTO encoder + frozen sinusoidal synth
  training/trainer              L5  build_modules / train steps / evaluate /
                                    predict / train (the training run)
  training/{checkpoint,logging} L5  run checkpoints, JSONL records
  configs, cli, analysis        L6  experiment registry, the CLI, the
                                    pitch-error report
  data                          L7  synthetic clips, the released .pth
  convert                       --  flax param / optimizer trees <-> torch
  kernel_gates, device          --  kernel gates, device + precision policy
"""
