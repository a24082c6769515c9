"""Mean device milliseconds of a train step's adam phase: the CUDA events
``train/splat.py train_step(mark=)`` records, as ``training()`` hands them to
``log_fn``, over the window's untraced steps."""


def read(r):
    return (r.get("phase_ms") or {}).get("adam")
