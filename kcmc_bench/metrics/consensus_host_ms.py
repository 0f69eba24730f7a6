"""consensus_host_ms: host milliseconds a batch inside the program's
`kcmc.match_consensus` range (matching, and the consensus or the field
estimate), over the traced calls."""

RANGE = "kcmc.match_consensus"


def read(run):
    if run.trace is None or RANGE not in run.trace.host_s:
        return None
    return 1e3 * run.trace.host_s[RANGE] / run.batches(run.traced_calls)
