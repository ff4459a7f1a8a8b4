from sot_tpu_torch.parallel.mesh import make_mesh, data_sharding, replicated  # noqa: F401
from sot_tpu_torch.parallel.sharded_ops import (  # noqa: F401
    stft_magnitude_frame_sharded,
    wasserstein_1d_freq_sharded,
)
from sot_tpu_torch.parallel.train import make_sharded_train_step  # noqa: F401
