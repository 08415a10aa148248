"""``allreduce_ms.<kind>``: device ms per step of the collectives' kernels
on rank 0, found by the name patterns of ``allreduce_ms.json`` (NCCL's).
A collective's kernel runs from the moment its rank reaches it until the
slowest rank has too, so this holds the wait for the slowest rank beside
the exchange itself."""

from portbench.common import metric_data


def read(ctx):
    patterns = metric_data("allreduce_ms")["patterns"]
    r = ctx["trace"]
    seconds = sum(s for name, (_, s) in r["kernels"].items() if any(p in name.lower() for p in patterns))
    if not seconds:
        return None
    return 1e3 * seconds / r["steps"]
