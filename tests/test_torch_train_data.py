"""The port's synthetic pipeline is the JAX package's, bitwise: the same
(seed, step) gives the same tokens, labels, frames and patches; host
sharding partitions the global batch; the chain's floor is equal."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticPipeline, make_batch_specs
from repro_torch.models.config import TRAIN_4K, ShapeSpec

try:    # the card's machine has no JAX
    from repro import configs as jconfigs
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticPipeline as JPipeline
    from repro.data import make_batch_specs as jax_make_batch_specs
    from repro.models.config import ShapeSpec as JShapeSpec
except ModuleNotFoundError:
    jconfigs = None


@pytest.mark.parametrize("arch,seed", [("minicpm-2b", 0), ("starcoder2-3b", 7),
                                       ("whisper-base", 1), ("internvl2-2b", 3),
                                       ("recurrentgemma-2b", 5)])
def test_global_batch_is_bitwise_the_jax_pipeline(arch, seed):
    tcfg, jcfg = configs.get(arch).reduced(), jconfigs.get(arch).reduced()
    tp = SyntheticPipeline(tcfg, ShapeSpec("t", 24, 4, "train"), DataConfig(seed=seed),
                           device="cpu")
    jp = JPipeline(jcfg, JShapeSpec("t", 24, 4, "train"), JDataConfig(seed=seed))
    for step in (0, 1, 17):
        got, want = tp.global_batch(step), jp.global_batch(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (k, step)
        host = tp.host_batch(step)
        for k in want:
            assert np.array_equal(host[k].numpy(), want[k])
    assert tp.optimal_loss() == jp.optimal_loss()
    specs = make_batch_specs(tcfg, ShapeSpec("t", 24, 4, "train"))
    jspecs = jax_make_batch_specs(jcfg, JShapeSpec("t", 24, 4, "train"))
    assert {k: s for k, (s, _) in specs.items()} == {k: v.shape for k, v in jspecs.items()}


def test_host_sharding_partitions_the_global_batch():
    cfg = configs.get("minicpm-2b").reduced()
    shape = ShapeSpec("t", 16, 6, "train")
    g = SyntheticPipeline(cfg, shape, DataConfig(seed=2), device="cpu").global_batch(3)
    parts = [SyntheticPipeline(cfg, shape, DataConfig(seed=2, host_index=i, host_count=3),
                               device="cpu").host_batch(3) for i in range(3)]
    for k in g:
        assert np.array_equal(torch.cat([p[k] for p in parts]).numpy(), g[k])
    assert g["tokens"].dtype == np.int32
    assert np.array_equal(g["tokens"][:, 1:], g["labels"][:, :-1])


def test_train_4k_shape():
    assert (TRAIN_4K.seq_len, TRAIN_4K.global_batch, TRAIN_4K.kind) == (4096, 256, "train")
    assert "train_4k" in configs.get("minicpm-2b").shapes
