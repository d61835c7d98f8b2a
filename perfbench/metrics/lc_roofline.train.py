"""The locally connected layers' share of their roofline: their least
time a step (each layer's forward and two backward products, bytes over
3.35 TB/s or operations over 67 TFLOP/s, the larger; from the
configuration's shapes, ``counts/deepface.py``) over ``lc_ms.train``, in
percent."""

from perfbench.core.spans import device_ms


def read(run):
    ms = device_ms(run, "lc")
    least = getattr(run.driver, "lc_least_s", None)
    if not ms or least is None:
        return None
    return least() * 1e3 / ms * 100.0
