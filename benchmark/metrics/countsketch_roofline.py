"""``countsketch_roofline``: one CountSketch encode of a ``[D]`` vector
(the compressor's ``device_encode``) and one decode of all D estimates
(``ops.countsketch.estimate_all``), through the program's public entries
at the cell's D, r and c, each timed by CUDA events over ``REPS`` calls
after a warm-up; the sum of their least times (the bytes of
``yardstick/bytes_moved.countsketch_bytes`` at the HBM peak) over the
sum of their measured times, in %. None outside sketch mode."""

import torch

from benchmark.yardstick import bytes_moved, peaks

REPS = 20


def _ms(fn) -> float:
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / REPS


def read(ctx):
    tr = ctx.cell.traffic
    sess = ctx.program.session
    if tr["optimizer"]["mode"] != "sketch" or sess.device.type != "cuda":
        return None
    from commefficient_tpu_torch.ops.countsketch import estimate_all

    d = sess.grad_size
    gen = torch.Generator(device=sess.device).manual_seed(0)
    v = torch.randn(d, generator=gen, device=sess.device)
    table = sess.compressor.device_encode(v)
    measured = (_ms(lambda: sess.compressor.device_encode(v))
                + _ms(lambda: estimate_all(sess.spec, table)))
    nbytes = bytes_moved.countsketch_bytes(d, tr["optimizer"])
    least = 1e3 * (nbytes["encode"] + nbytes["decode"]) / \
        peaks.HBM_BYTES_PER_S
    return 100.0 * least / measured
