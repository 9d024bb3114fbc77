"""Kernels: the shared_z tail's share of its roofline, in %: the least time
the card could take for the calls' work (bytes over 3.35 TB/s or
operations over their peaks, `flops.shared_z_work` at B = h w, K =
n_coarse, H = d_hidden in the compute dtype) over the kernels' time in
the traced stretch."""
from port_bench import flops, readers


def read(run):
    secs, n = readers.kernel_seconds(run, "shared_z")
    if not n or secs <= 0:
        return None
    conf = run.conf
    h, w = conf["data"]["image_size"]
    nbytes, ops = flops.shared_z_work(
        h * w, conf["renderer"]["n_coarse"],
        conf["model_conf"]["mlp_coarse"]["d_hidden"],
        bool(conf.get("bf16", True)))
    return 100.0 * n * flops.bound_seconds(nbytes, ops) / secs
