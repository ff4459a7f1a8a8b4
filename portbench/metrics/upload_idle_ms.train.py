"""Device-idle milliseconds a step inside the program's ``sot.train.upload``
spans (``trainer.TrainGraph``: a chunk's offsets copied in from pageable
host memory, which drains the queue): the spans' length less the device's
busy time in them, over the traced window's steps. Moves
train_frames_per_s."""

from portbench import spans


def read(trace):
    return spans.idle_ms_per_step(trace, "sot.train.upload")
