"""enc_device_ms: milliseconds the phase-timed batch's host spends around
the device: ``encode.h2d`` (the packed rows and lengths copied to the
card), ``encode.scan`` (the fused scan's launch) and ``encode.d2h`` (the
wait for the scan and the two copies back, models/base.fetch_head)."""


def read(r):
    return r.phase_ms("encode.h2d", "encode.scan", "encode.d2h")
