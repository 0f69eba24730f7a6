"""inlier_share: consensus inliers over matches, summed over the frames
of the traced calls (diagnostics n_inliers / n_matches), %."""


def read(run):
    matches = sum(int(c["counts"]["n_matches"].sum()) for c in run.traced_calls)
    if not matches:
        return None
    return 100.0 * sum(int(c["counts"]["n_inliers"].sum()) for c in run.traced_calls) / matches
