"""capture_ms: milliseconds a train spends in the program's phase
``train.capture``, the training loop's CUDA graph captures
(ops/train_loop.BlockRunner); 0 in a train that captured none."""


def read(r):
    return r.phase_ms("train.capture")
