"""The toy model's counts: frames a clip and the operations of its linear
maps (the synth not counted)."""


def frames_per_clip(cfg: dict) -> int:
    return cfg["n_samples"] // cfg["hop"]


def forward_flops(cfg: dict, clips: int) -> float:
    return 2.0 * (cfg["n_harmonics"] + 1) * cfg["hop"] * frames_per_clip(cfg) * clips


def train_step_flops(cfg: dict, clips: int) -> float:
    return 3.0 * forward_flops(cfg, clips)
