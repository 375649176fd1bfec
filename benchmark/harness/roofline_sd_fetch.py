"""The yardstick of SVAO phase 2's stochastic-depth fetch at stochMapDivisor
1 and 2: the bytes the fetch of one frame has to move, counted from the
configuration file and the graph's settings (never from the program), and
the least time the card can take for them (harness/roofline.py's peaks).

Phase 2 reads, for each of the ring's directions, each of the 16 dither
classes and each quarter-resolution texel, the k depths of one SD-map
texel. Each of those values is written once, 4 bytes each, and the SD map
is read once:

    directions * 16 * k * qh * qw * 4 + sd_h * sd_w * k * 4 bytes.

The graph's settings (scripts/SVAO_small.py and SVAO's defaults): the
GuardBand pass widens the frame by GUARD_BAND_PX on every side, SVAO
samples DIRECTIONS ring directions (its sampleCount) and the SD map holds
SD_SAMPLES depths a texel (its stochSamples). The frame, padded to a
multiple of 4, is qh x qw quarter texels; the SD map is the frame at
1/divisor with stochMapGuardBand / divisor texels more on every side.

At BASELINE config 3 (1920x1080, divisor 1, a 512 px SD guard band) that
is 8 * 16 * 4 * 302 * 512 * 4 = 316,669,952 bytes written and 3072 * 2232
* 4 * 4 = 109,707,264 read: 426,377,216 bytes, 0.1273 ms at 3.35 TB/s."""
from __future__ import annotations

from . import roofline

GUARD_BAND_PX = 64      # SVAO_small.py's GuardBand pass
DIRECTIONS = 8          # SVAO's sampleCount
SD_SAMPLES = 4          # SVAO's stochSamples
SD_GUARD_BAND_PX = 512  # SVAO's stochMapGuardBand, unless overridden
BYTES_PER_VALUE = 4     # float32 depths


def sd_fetch_bytes(cfg: dict) -> int | None:
    """Bytes of one frame's phase-2 SD fetch of configuration `cfg`, or
    None where its SVAO does not take the SD map at divisor 1 or 2."""
    svao = cfg.get("pass_overrides", {}).get("SVAO", {})
    div = int(svao.get("stochMapDivisor", 4))
    if div not in (1, 2):
        return None
    guard = int(svao.get("stochMapGuardBand", SD_GUARD_BAND_PX)) // div
    w = int(cfg["width"]) + 2 * GUARD_BAND_PX
    h = int(cfg["height"]) + 2 * GUARD_BAND_PX
    qh, qw = -(-h // 4), -(-w // 4)
    sd_h, sd_w = -(-h // div) + 2 * guard, -(-w // div) + 2 * guard
    written = DIRECTIONS * 16 * SD_SAMPLES * qh * qw
    read = sd_h * sd_w * SD_SAMPLES
    return (written + read) * BYTES_PER_VALUE


def sd_fetch_bound_s(cfg: dict) -> float | None:
    """The least time one frame's SD fetch can take on the card."""
    nbytes = sd_fetch_bytes(cfg)
    return None if nbytes is None else roofline.bound_s(0.0, nbytes)
