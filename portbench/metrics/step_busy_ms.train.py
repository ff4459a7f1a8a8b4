"""Device-busy milliseconds per train step: the union of the device's
kernel, copy and set intervals inside the traced window over the steps in
it (``training/trainer.TrainGraph``'s replays). Moves train_frames_per_s."""


def read(trace):
    if trace.kind != "train" or trace.units == 0 or trace.busy_us == 0:
        return None
    return trace.busy_us / 1e3 / trace.units
