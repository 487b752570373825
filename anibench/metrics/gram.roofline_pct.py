"""The device Gram's share of its roofline: the least time of its
inputs (``roofline/gram.py``) over the device time inside the Gram calls
(the union of the kernels and copies of the ``anibench.gram`` ranges),
in percent, over all calls of the window.

The probe wraps ``ops.minhash.intersection_matrix_device``, records the
sketch sizes of each call and opens the ``anibench.gram`` range."""

from anibench import tracing
from anibench.roofline import gram


def install(probes) -> None:
    minhash = probes.module("pyani_plus_tpu_torch.ops.minhash")
    sizes = probes.data.setdefault("gram_sizes", [])

    def wrap(real):
        def gram_call(sketches, *args, **kwargs):
            with probes.lock:
                sizes.append([int(s.hashes.size) for s in sketches])
            with probes.torch.profiler.record_function("anibench.gram"):
                return real(sketches, *args, **kwargs)

        return gram_call

    probes.replace(minhash, "intersection_matrix_device", wrap)


def read(data: dict) -> float | None:
    device_s = tracing.device_seconds_within(data["timeline"], "gram")
    if not data.get("gram_sizes") or device_s <= 0:
        return None
    least_s = sum(gram.least(s)[0] for s in data["gram_sizes"])
    return 100.0 * least_s / device_s
