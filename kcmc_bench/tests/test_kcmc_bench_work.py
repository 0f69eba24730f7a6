"""The benchmark's own work counts reproduce the port's kernel table
(PERF.md) at the table's shapes: the bound ms of K1, K2, K4, K5, K7 and
K8, which chip_smoke.py computed and the card's runs were held to."""

import pytest

from kcmc_bench import work
from kcmc_bench.reference.patterns import PATCH_RADIUS, ROT_RADIUS

B, H, W = 32, 512, 512


@pytest.mark.parametrize("kernel, seconds, table_ms", [
    ("K1 detect_response", lambda: work.detect(B, H, W, 1.5, 2.0), 0.0501),
    ("K2 extract_blended", lambda: work.patches(B, H, W, B * 512, 2 * PATCH_RADIUS + 2,
                                                PATCH_RADIUS), 0.0127),
    ("K4 moment_maps", lambda: work.moments(B, H, W), 0.0271),
    ("K5 binned_select_rows", lambda: work.select(B * 4368, (2 * ROT_RADIUS + 1) ** 2, 512),
     0.1391),
    ("K7 warp_batch_matrix", lambda: work.warp_matrix(B, H, W), 0.0200),
    ("K8 warp_batch_field", lambda: work.warp_field(B, H, W, 8, 8), 0.0200),
])
def test_kernel_table_bounds(kernel, seconds, table_ms):
    assert round(seconds() * 1e3, 4) == table_ms


def test_batch_work_is_the_sum_of_its_steps():
    import numpy as np

    from kcmc_bench.reference.oracle import Settings

    s = Settings({"model": "piecewise", "harris_window_sigma": 1.5, "blur_sigma": 2.0,
                  "oriented": None, "patch_grid": [8, 8], "polish_grid": [4, 4],
                  "n_hypotheses": 128, "patch_hypotheses": 32, "patch_model": "translation",
                  "field_passes": 3, "field_polish": 4})
    kp, m = np.full(32, 500), np.full(32, 250)
    t = work.batch_seconds(s, H, W, kp, m, 500)
    steps = (work.detect(B, H, W, 1.5, 2.0) + work.patches(B, H, W, 32 * 500, 28, 13)
             + work.match(32 * 500, 500) + work.consensus(32 * 250, 128, 6)
             + work.consensus(32 * 250, 32, 6, 3) + 5 * work.warp_field(B, H, W, 8, 8)
             + 4 * work.polish(B, H, W))
    assert t == pytest.approx(steps, rel=1e-12)
