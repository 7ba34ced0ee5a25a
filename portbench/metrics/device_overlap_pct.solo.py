"""device_overlap_pct.solo: Share of the device operations' time in the traced window that ran beside another operation:
the sum of every operation's device seconds less the union of device activity, over that sum, in %. About 0 where each
kernel starts after the one before it has completed; a programmatic dependent launch starts beside the one before it."""
LAYER = 'kernels (K2: ops/quant.py, csrc/int8_gemv.cu)'
SOURCE = 'device_trace'
MOVES = 'audio_rtf'


def read(window):
    tr = window.get("trace")
    total = sum(k["s"] for k in ((tr or {}).get("kernels") or {}).values())
    if total <= 0:
        return None
    return 100.0 * max(0.0, total - tr["busy_s"]) / total
