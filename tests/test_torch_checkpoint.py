"""The port's checkpoints (`repro_torch/checkpoint/checkpoint.py`): the
reference's cases of tests/test_train_stack.py (round trip and
atomicity, async, prune), bf16 leaves bit for bit, a host snapshot that
an in-place update after `save_async` cannot reach, a model restored in
place, AdamW's state restored, and the manifest's names checked."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import modules as nn  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = {"a": np.arange(6).reshape(2, 3).astype(np.float32),
            "b": [np.ones(4), np.zeros((2, 2))]}
    ckpt.save(str(tmp_path), tree, step=7, meta={"x": 1})
    out, step, meta = ckpt.restore(str(tmp_path), tree)
    assert step == 7 and meta == {"x": 1}
    np.testing.assert_array_equal(np.asarray(out["a"]), tree["a"])
    np.testing.assert_array_equal(out["b"][1], tree["b"][1])
    # LATEST points at a complete checkpoint even with a stale tmp dir
    os.makedirs(str(tmp_path / "step_00000009.tmp"), exist_ok=True)
    assert ckpt.latest_step(str(tmp_path)) == 7
    man = json.loads((tmp_path / "step_00000007" / "manifest.json")
                     .read_text())
    assert man["names"] == ["a", "b.0", "b.1"]
    assert man["shapes"] == [[2, 3], [4], [2, 2]]
    assert man["dtypes"] == ["float32", "float64", "float64"]


def test_async_checkpointer(tmp_path):
    c = ckpt.AsyncCheckpointer(str(tmp_path))
    c.save_async({"w": torch.ones(8)}, step=1)
    c.wait()
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_checkpoint_prune(tmp_path):
    for s in [1, 2, 3, 4]:
        ckpt.save(str(tmp_path), {"w": np.zeros(2)}, step=s)
    ckpt.prune_old(str(tmp_path), keep=2)
    steps = sorted(int(d[5:]) for d in os.listdir(str(tmp_path))
                   if d.startswith("step_"))
    assert steps == [3, 4]


def test_bf16_leaf_round_trip_is_bit_exact(tmp_path):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(33, 7, generator=g).to(torch.bfloat16)
    x[0, :4] = torch.tensor([float("inf"), float("-inf"), float("nan"),
                             -0.0]).to(torch.bfloat16)
    tree = {"x": x, "y": torch.arange(5, dtype=torch.int32), "s": 3}
    ckpt.save(str(tmp_path), tree, step=2)
    man = json.loads((tmp_path / "step_00000002" / "manifest.json")
                     .read_text())
    assert man["dtypes"] == ["bfloat16", "int32", "int64"]
    out, _, _ = ckpt.restore(str(tmp_path), tree)
    assert out["x"].dtype == torch.bfloat16 and out["s"] == 3
    assert torch.equal(out["x"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(out["y"], tree["y"])
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.restore(str(tmp_path), {"x": np.zeros(1), "y": tree["y"],
                                     "s": 3})


def test_snapshot_is_not_reached_by_an_in_place_update(tmp_path):
    w = torch.zeros(1 << 16)
    c = ckpt.AsyncCheckpointer(str(tmp_path))
    c.save_async({"w": w}, step=1)
    w.add_(1.0)              # the optimizer's next update, in place
    c.wait()
    out, _, _ = ckpt.restore(str(tmp_path), {"w": w})
    assert float(out["w"].abs().max()) == 0.0
    assert float(w.min()) == 1.0


def test_model_and_adamw_state_round_trip(tmp_path):
    cfg = configs.get_smoke_config("deepseek-v2-lite-16b")
    p = lm.lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    p16 = nn.map_params(p, lambda t: t.to(torch.bfloat16))
    state = opt.adamw_init(p16, keep_master=True)
    state.m["embed"].fill_(0.5)
    state = state._replace(step=12)
    ckpt.save(str(tmp_path), (p16, state), step=12)
    q = nn.map_params(p16, torch.zeros_like)
    fresh = opt.adamw_init(q, keep_master=True)
    ids = [id(t) for t in q.parameters()]
    (q2, s2), step, _ = ckpt.restore(str(tmp_path), (q, fresh))
    assert step == 12 and q2 is q and s2.step == 12
    assert [id(t) for t in q.parameters()] == ids        # filled in place
    for (k, a), (_, b) in zip(p16.named_parameters(), q.named_parameters()):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), k
    assert float(s2.m["embed"].min()) == 0.5
    assert all(torch.equal(s2.master[k], state.master[k])
               for k in state.master)
    # a tree named otherwise is refused
    other = lm.lm_init(configs.get_smoke_config("phi3-mini-3.8b"),
                       torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), (other, fresh))
