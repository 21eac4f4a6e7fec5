"""The launch counts `chip_smoke.py` holds the kernels to, checked on the CPU.

`chip_smoke.py` fails a training path when a kernel's launches differ from
the count the run's own records imply (`expected_launches`): the
optimizer's batched passes per round (`objective_passes`) times the
attention layers each pass runs, plus the evaluation sweeps. On the CPU the
wrappers take their plain versions and launch nothing, so here each
wrapper is wrapped in a counter of its calls, which are the launches it
would make on the card, and the same small drives as the slice tests run:
the LM at S = 128 over all six groups (the embedding, every block and the
head: 4, 4..1 and 0 attention layers behind the active group), the ViT
with the fused direction over its first two groups, two averaging rounds
and evaluations each, the admm drive (Net, two groups, three ADMM rounds
each), the no_consensus drive (Net1, one group, two epochs), and the
switch-MoE ViT over the ViT's two groups, whose grouped
GEMM launches twice a block in every forward, twice in each
block the gradient crosses and twice more (the weight gradients) in the
block the group trains (`expected_grouped`), and the same MoE ViT with
probe fans of 4 under both folds, each fan one forward pass. Counts are
exact: no tolerance.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu_torch.data import synthetic_cifar
from federated_pytorch_test_tpu_torch.engine import ExperimentConfig, Trainer, get_preset
from federated_pytorch_test_tpu_torch.federated_lm import FederatedLM, LMConfig
from federated_pytorch_test_tpu_torch.ops import compact_cuda, flash_cuda, grouped_gemm
from federated_pytorch_test_tpu_torch.optim import LBFGSConfig, lbfgs_init, lbfgs_step

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _count_calls(monkeypatch, module, names, counts):
    """Replace each wrapper by one that counts its calls into `counts`."""
    for name in names:
        counts[name] = 0
        fn = getattr(module, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            counts[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)


def test_lm_launches_equal_the_count_its_records_imply(monkeypatch):
    # `flash_bwd` launches dq and dk/dv once each on the card (on the CPU it
    # goes to the plain backward directly)
    counts = {}
    _count_calls(monkeypatch, flash_cuda, ("flash_fwd", "flash_bwd"), counts)
    lm = FederatedLM(LMConfig(k=2, vocab=32, dim=32, num_heads=2, seq=128, batch=2, n_batch=2,
                              attn_impl="flash", device="cpu"), verbose=False)
    rec = lm.run()
    exp = chip_smoke.expected_launches(rec, lm.model, sweep_passes=1)
    assert [chip_smoke.attention_grad_layers(lm.model, g) for g in lm.group_order] == [4, 4, 3, 2, 1, 0]
    assert counts == {"flash_fwd": exp["forward"], "flash_bwd": exp["backward"]}
    assert len(rec.series["objective_passes"]) == 6 and exp["backward"] > 0


def test_vit_launches_equal_the_count_its_records_imply(monkeypatch):
    counts = {}
    _count_calls(monkeypatch, flash_cuda, flash_cuda.RECT_KERNELS, counts)
    _count_calls(monkeypatch, compact_cuda, tuple(compact_cuda.LAUNCHES), counts)
    cfg = ExperimentConfig(model="vit", model_kwargs={"patch": 2, "attn_impl": "flash"}, device="cpu", batch=8,
                           eval_batch=8, nloop=1, nadmm=2, max_groups=2, lbfgs_direction="pallas")
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(24, 16))
    rec = tr.run()
    exp = chip_smoke.expected_launches(rec, tr.model, sweep_passes=len(tr.test_imgs))
    assert len(tr.test_imgs) == 2  # two test batches an evaluation
    assert counts == {"flash_fwd_rect": exp["forward"], "flash_bwd_dq_rect": exp["backward"],
                      "flash_bwd_dkv_rect": exp["backward"],
                      "fused_gram_projections": exp["direction"], "fused_direction_assembly": exp["direction"]}


@pytest.mark.parametrize("remat", [False, True])
def test_vit_bf16_launches_equal_the_count_its_records_imply(monkeypatch, remat):
    # the mixed-precision ViT path (compute_dtype bf16, attention at
    # 'default'): the same wrappers, at one pass; under remat every gradient
    # pass runs each block's forward once more (the backward's recomputation)
    counts = {}
    _count_calls(monkeypatch, flash_cuda, flash_cuda.RECT_KERNELS, counts)
    _count_calls(monkeypatch, compact_cuda, tuple(compact_cuda.LAUNCHES), counts)
    cfg = ExperimentConfig(model="vit", model_kwargs=chip_smoke.VIT_BF16_KWARGS, device="cpu", batch=8,
                           eval_batch=8, nloop=1, nadmm=1, max_groups=2, lbfgs_direction="pallas",
                           compute_dtype="bfloat16", remat=remat)
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(24, 16))
    rec = tr.run()
    exp = chip_smoke.expected_launches(rec, tr.model, sweep_passes=len(tr.test_imgs), remat=remat)
    plain = chip_smoke.expected_launches(rec, tr.model, sweep_passes=len(tr.test_imgs))
    assert exp["forward"] - plain["forward"] == (tr.model.DEPTH * sum(r["value"]["grad"] for r in
                                                                       rec.series["objective_passes"]) if remat else 0)
    assert counts == {"flash_fwd_rect": exp["forward"], "flash_bwd_dq_rect": exp["backward"],
                      "flash_bwd_dkv_rect": exp["backward"],
                      "fused_gram_projections": exp["direction"], "fused_direction_assembly": exp["direction"]}


def test_admm_launches_equal_the_count_its_records_imply(monkeypatch):
    # the admm drive of tests/test_torch_admm_slice.py: one direction (a
    # gram and an assembly) per inner iteration, whatever BB does with rho
    counts = {}
    _count_calls(monkeypatch, compact_cuda, tuple(compact_cuda.LAUNCHES), counts)
    cfg = get_preset("admm", batch=40, nloop=1, nadmm=3, max_groups=2, lbfgs_direction="pallas", device="cpu")
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(240, 60))
    rec = tr.run()
    exp = chip_smoke.expected_launches(rec)
    assert len(rec.series["objective_passes"]) == 2 and exp["direction"] > 0
    assert counts == {"fused_gram_projections": exp["direction"], "fused_direction_assembly": exp["direction"]}


def test_no_consensus_launches_equal_the_count_its_records_imply(monkeypatch):
    # the no_consensus drive of tests/test_torch_no_consensus_slice.py (Net1,
    # the whole vector one group, two epochs): one direction per inner
    # iteration; the per-epoch evaluations launch no compact kernel
    counts = {}
    _count_calls(monkeypatch, compact_cuda, tuple(compact_cuda.LAUNCHES), counts)
    cfg = get_preset("no_consensus", batch=40, nepoch=2, eval_batch=30, lbfgs_direction="pallas", device="cpu")
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(240, 60))
    rec = tr.run()
    exp = chip_smoke.expected_launches(rec)
    assert len(rec.series["objective_passes"]) == 1 and len(rec.series["test_accuracy"]) == 3
    assert exp["direction"] > 0
    assert counts == {"fused_gram_projections": exp["direction"], "fused_direction_assembly": exp["direction"]}


def test_vit_moe_launches_equal_the_count_its_records_imply(monkeypatch):
    # the grouped GEMM's three roles (its split sum is a launch inside
    # `grouped_matmul_drhs` on the card, counted from `split_k`): groups 0
    # (the gradient crosses every block) and 1 (block 0's experts train)
    counts = {}
    _count_calls(monkeypatch, grouped_gemm, ("grouped_matmul_fwd", "grouped_matmul_dlhs", "grouped_matmul_drhs"),
                 counts)
    _count_calls(monkeypatch, flash_cuda, flash_cuda.RECT_KERNELS, counts)
    cfg = ExperimentConfig(model="vit", model_kwargs={"patch": 2, "attn_impl": "flash", "dim": 32, "num_heads": 2,
                                                      "moe_experts": 2},
                           device="cpu", batch=8, eval_batch=8, nloop=1, nadmm=2, max_groups=2)
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(24, 16))
    rec = tr.run()
    exp = chip_smoke.expected_launches(rec, tr.model, sweep_passes=len(tr.test_imgs))
    assert [chip_smoke.active_blocks(tr.model, g) for g in range(6)] == [0, 1, 1, 1, 1, 0]
    grouped = chip_smoke.expected_grouped(exp, cfg)
    # 1,280 slots an expert (2,048 tokens a client): both weight gradients in two chunks
    assert grouped["grouped_matmul_sum"] == 2 * exp["weight_backward"]
    assert exp["weight_backward"] > 0
    assert counts == {"grouped_matmul_fwd": grouped["grouped_matmul"],
                      "grouped_matmul_dlhs": grouped["grouped_matmul_dlhs"],
                      "grouped_matmul_drhs": grouped["grouped_matmul_drhs"],
                      "flash_fwd_rect": exp["forward"], "flash_bwd_dq_rect": exp["backward"],
                      "flash_bwd_dkv_rect": exp["backward"]}


@pytest.mark.parametrize("fold", ["gemm", "vmap"])
def test_a_probe_fan_is_one_forward_in_every_block(monkeypatch, fold):
    # `linesearch_probes=4` on the switch-MoE ViT over block1 (block0 below
    # it runs once a fan for K clients, the blocks above it for K·P) and the
    # head (every block below it): each fan is one value pass, each block's
    # attention and experts launch once in it, so the formula needs no new
    # term; the compact kernels, one per direction, do not run in a fan
    counts = {}
    _count_calls(monkeypatch, grouped_gemm, ("grouped_matmul_fwd", "grouped_matmul_dlhs", "grouped_matmul_drhs"),
                 counts)
    _count_calls(monkeypatch, flash_cuda, flash_cuda.RECT_KERNELS, counts)
    _count_calls(monkeypatch, compact_cuda, tuple(compact_cuda.LAUNCHES), counts)
    cfg = ExperimentConfig(model="vit", model_kwargs={"patch": 2, "attn_impl": "flash", "dim": 32, "num_heads": 2,
                                                      "moe_experts": 2},
                           device="cpu", batch=8, eval_batch=8, nloop=1, nadmm=1, lbfgs_direction="pallas",
                           linesearch_probes=4, client_fold=fold)
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(24, 16))
    tr.group_order = [2, 5]
    rec = tr.run()
    passes = [r["value"] for r in rec.series["objective_passes"]]
    assert all(p["value"] > 0 for p in passes)  # the fans ran
    exp = chip_smoke.expected_launches(rec, tr.model, sweep_passes=len(tr.test_imgs))
    grouped = chip_smoke.expected_grouped(exp, cfg)
    assert counts == {"grouped_matmul_fwd": grouped["grouped_matmul"],
                      "grouped_matmul_dlhs": grouped["grouped_matmul_dlhs"],
                      "grouped_matmul_drhs": grouped["grouped_matmul_drhs"],
                      "flash_fwd_rect": exp["forward"], "flash_bwd_dq_rect": exp["backward"],
                      "flash_bwd_dkv_rect": exp["backward"],
                      "fused_gram_projections": exp["direction"], "fused_direction_assembly": exp["direction"]}


def test_grouped_formula_at_the_chip_shapes():
    # the MoE ViT path's own shapes: both weight gradients split, once each
    cfg = get_preset("fedavg", model="vit", model_kwargs=chip_smoke.VIT_MOE_KWARGS)
    assert chip_smoke.moe_shapes(cfg) == (24, 20480, 20000, 64, 256)
    exp = {"forward": 10, "backward": 7, "weight_backward": 3}
    assert chip_smoke.expected_grouped(exp, cfg) == {"grouped_matmul": 20, "grouped_matmul_dlhs": 14,
                                                     "grouped_matmul_drhs": 6, "grouped_matmul_sum": 6}


def test_gate_fails_on_any_difference(capsys):
    chip_smoke.gate_launches("lm", {"flash_bwd_dq": 224}, {"flash_bwd_dq": 224})
    assert "lm launches flash_bwd_dq expected=224 counted=224" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        chip_smoke.gate_launches("lm", {"flash_bwd_dq": 448}, {"flash_bwd_dq": 224})


def test_batched_passes_agree_with_the_per_client_counters():
    # a client stays in the batched loop only while it re-evaluates, so the
    # gradient passes of a step are the most any client made, and the
    # directions the most inner iterations; a probe pass serves every
    # client still searching, so there are at least as many as any one
    # client's probes
    rng = np.random.default_rng(0)
    n = 12
    a = [rng.normal(size=(n, n)) for _ in range(3)]
    mats = torch.tensor(np.stack([m @ m.T + (n + 5 * k) * np.eye(n) for k, m in enumerate(a)]), dtype=torch.float32)
    rhs = torch.tensor(rng.normal(size=(3, n)), dtype=torch.float32)

    def loss(x):
        return 0.5 * (x * (mats @ x[..., None])[..., 0]).sum(-1) - (rhs * x).sum(-1)

    cfg = LBFGSConfig(max_iter=6, history_size=4, line_search=True, batch_mode=True)
    x = torch.zeros(3, n)
    state = lbfgs_init(x, cfg)
    grad = value = direction = 0
    for _ in range(3):
        x, state, aux = lbfgs_step(loss, x, state, cfg)
        grad += int(aux.func_evals.max())
        direction += int(aux.n_inner.max())
        value += int(aux.ls_evals.max())
    assert (state.grad_passes, state.direction_passes) == (grad, direction)
    assert state.value_passes >= value and state.direction_passes > 0
