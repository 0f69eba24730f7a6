"""kernel_roofline_share: the least time the H100 needs for the work of
every step of the traced calls' batch programs and reference
preparations (kcmc_bench/work.py, at the cell's shapes and the counts
the calls reported), over all kernel time on the device in the traced
window, %. Not clamped: above 100 means the work is counted too high or
the kernel time misses work."""

from kcmc_bench import work


def read(run):
    if run.trace is None or run.trace.kernel_s <= 0:
        return None
    s, (H, W) = run.settings, run.shape
    B = int(s.batch_size)
    least = 0.0
    for c in run.traced_calls:
        kp, m = c["counts"]["n_keypoints"], c["counts"]["n_matches"]
        ref_kp = int(kp[0])  # frame 0 is the reference frame
        least += work.reference_seconds(s, H, W, ref_kp)
        for lo in range(0, len(kp), B):
            least += work.batch_seconds(s, H, W, kp[lo:lo + B], m[lo:lo + B], ref_kp)
    return 100.0 * least / run.trace.kernel_s
