"""The paths ``chip_smoke.py``'s LM cells run on the card, on the CPU at
reduced widths against the JAX package, and the cells' bytes.

* Reduced gemma-2b on 1,100 tokens, past one attention chunk
  (``ATTN_CHUNK`` = 1024: the prefill's running softmax across two KV
  chunks), and a cache of 2,100 slots, past one 2,048-slot decode chunk:
  prefill logits, the cache and two decode steps, f32 weights carried
  from the JAX model, within 1e-5 (``tests/test_torch_transformer.py``'s
  TOL);
* reduced paligemma-3b the same way behind its 8 patch embeddings: the
  prefix-LM mask in the first of two KV chunks;
* every LM cell of ``chip_smoke.py``'s tables reckoned on meta tensors
  (bf16 weights at the cell's depth, the init's f32 draw of the largest
  leaf, its caches; the f32 consistency model's weights, draw and two
  caches) within one card's ``roofline.HBM_PER_CHIP``;
* every training row (``TRAIN_CELLS``) built on meta at its cut: its
  weights, moments and gradients (``train_cell_bytes``) within one card;
  int8 moments exactly where the full config's dry run selects them
  (``_QUANT_OPT_THRESHOLD``), microbatches of the dry run's 2 rows; a cut
  row's depth the most its counted step on meta (``count_train_cell``:
  the state and the step's peak live bytes) fits in one card, a
  multiple of the hybrid's block pattern.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.launch.roofline import HBM_PER_CHIP
from repro_torch.models.transformer import ATTN_CHUNK

pytest.importorskip("jax")
from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from test_torch_transformer import TOL, _batch, _carried, _run_both  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LONG, LONG_CACHE = 1100, 2100


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["gemma-2b", "paligemma-3b"])
def test_prompt_past_one_attention_chunk_matches_jax(arch):
    """Prefill of 1,100 text tokens (after the vlm's patches), the cache,
    and two decode steps over 2,100 slots against the JAX model, f32."""
    m = _carried(jget_reduced(arch), get_reduced_config(arch), torch.float32)
    batch = _batch(m["cfg"], seed=13, t=LONG)
    assert batch["tokens"].shape[1] > ATTN_CHUNK
    assert LONG_CACHE > 2048
    cache = _run_both(m, batch, steps=2, tol=TOL, cache_len=LONG_CACHE)
    assert cache["k"].shape[2] == LONG_CACHE


CS = _chip_smoke()
CELLS = [(phase, cell) for phase, cells in (
    ("lm_dense", CS.DENSE_CELLS), ("lm_moe", CS.MOE_CELLS),
    ("lm_hybrid", CS.HYBRID_CELLS)) for cell in cells]


@pytest.mark.parametrize(
    "phase,cell", CELLS,
    ids=[f"{p}-{c.arch}-{c.batch}x{c.prompt}" for p, c in CELLS])
def test_lm_cell_fits_one_card(phase, cell):
    r = CS.lm_cell_bytes(cell)
    assert r["weights"] > 0 and r["caches"] > 0
    assert r["total"] == r["weights"] + r["f32_draw"] + r["caches"]
    assert r["total"] <= HBM_PER_CHIP, (phase, cell, r)
    if cell.f32_layers is not None:
        assert r["f32_total"] <= HBM_PER_CHIP, (phase, cell, r)


TRAIN = list(enumerate(CS.TRAIN_CELLS))


@pytest.mark.parametrize(
    "idx,cell", TRAIN,
    ids=[f"row{i + 1}-{c.arch}-n_micro{c.n_micro}" for i, c in TRAIN])
def test_train_cell_depth_fits_one_card(idx, cell):
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _QUANT_OPT_THRESHOLD
    from repro_torch.models import build_model

    r = CS.train_cell_bytes(cell)
    assert r["total"] == r["weights"] + r["moments"] + r["grads"]
    assert max(r["total"], r["init"]) <= HBM_PER_CHIP, (cell, r)
    full = get_config(cell.arch)
    assert cell.int8 == (build_model(full, device="meta").n_params
                         > _QUANT_OPT_THRESHOLD)
    if idx:                          # row 1 is the one-microbatch step
        assert cell.n_micro == max(1, cell.batch // 2)
    if cell.layers is None:
        return
    step = (len(full.recurrent.block_pattern) if full.family == "hybrid"
            else 1)
    assert cell.layers % step == 0 and cell.layers < full.n_layers
    assert CS.count_train_cell(cell)["total_bytes"] <= HBM_PER_CHIP
    assert CS.count_train_cell(cell, cell.layers + step)["total_bytes"] \
        > HBM_PER_CHIP
