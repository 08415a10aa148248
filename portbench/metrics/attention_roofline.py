"""``attention_roofline.<kind>``: the least time of the steps' attention
work over the device time of the kernels that did it, forward and
backward together.

The least time of one call is ``max(bytes / HBM bandwidth, FLOPs /
dense bf16 peak)``: bytes of q, k, v and o, and with a backward of dO,
dq, dk and dv, each counted once; FLOPs over each query row against that
row's unmasked keys, which is what these inputs need: ``4 d`` a pair and
head forward (``QK^T``, ``PV``), ``8 d`` backward (``dP``, ``dV``,
``dQ``, ``dK``). The kernels are found by the name patterns of
``attention_roofline.json``."""

from portbench.common import metric_data


def least_seconds(call: dict, peaks: dict) -> float:
    rows, T, H, eb = len(call["lengths"]), call["seq"], call["hidden"], call["element_bytes"]
    pairs = T * sum(call["lengths"])
    tensors = 8 if call["backward"] else 4
    flops = (12 if call["backward"] else 4) * H * pairs
    nbytes = tensors * rows * T * H * eb
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["bf16_flops"])


def read(ctx):
    peaks = ctx["peaks"]
    if not peaks:
        return None
    patterns = metric_data("attention_roofline")["patterns"]
    r = ctx["trace"]
    device = sum(s for name, (_, s) in r["kernels"].items() if any(p in name.lower() for p in patterns))
    least = sum(least_seconds(c, peaks) for c in r["work"].get("attention", ()))
    if device <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / device
