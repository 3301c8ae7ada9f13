"""The served model's share of the H100's dense bfloat16 peak, in
percent: the model operations of every batch served untraced in the
window, in the published formulation (`roofline.lm_flops`, from the
configuration file alone, whatever path the program takes), over the
host wall of those batches times 989.4 TFLOP/s."""
from dasbench import roofline


def read(r):
    done = [b for b in r.batches if not b["traced"]]
    if not done:
        return None
    flops = sum(roofline.lm_flops(r.config, b["prompt_len"], b["new_tokens"],
                                  b["batch"]) for b in done)
    return 100.0 * flops / (sum(b["wall_s"] for b in done)
                            * roofline.BF16_OPS_PER_S)
