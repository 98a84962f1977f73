"""The serve CLI of the port on the CPU (``launch.serve.main``) against
the JAX reference's launcher loop, for the attention family and the MoE
ids at smoke size, f32: the same weights and stub inputs, drawn in its
order, give the same greedy tokens exactly (F15 and F16 included).
Split from ``tests/test_torch_archs.py`` so that ``--dist loadfile`` can
give the two to two workers.
"""
from __future__ import annotations

import numpy as np
import pytest

from _torch_ref import reference
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models.convert import numpy_params

NEW = ("gemma2-2b", "gemma3-12b", "paligemma-3b", "seamless-m4t-large-v2",
       "deepseek-67b")
MOE = ("mixtral-8x7b", "phi3.5-moe-42b", "jamba-1.5-large-398b")


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


def _j(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("arch,temperature", [
    *(pytest.param(a, 0.0, id=a) for a in NEW + MOE),
    pytest.param("mixtral-8x7b", 0.8, id="mixtral-8x7b-temperature-0.8")])
def test_serve_cli_matches_reference_launcher(ref, arch, temperature,
                                              capsys):
    """The CLI's greedy tokens equal the reference launcher's loop on the
    same weights and stub inputs, drawn in its order: prefix positions
    counted, the enc-dec decoded without its encoder output (F15), and
    ``--temperature`` taken and not read, so that decoding stays greedy
    at any value (F16: the reference's launcher parses it and never
    reads it)."""
    import jax.numpy as jnp
    b, s, gen = 2, 24, 12
    res = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", str(b), "--prompt-len", str(s),
                       "--gen", str(gen), "--seed", "5",
                       "--temperature", str(temperature)])
    assert "first sequence:" in capsys.readouterr().out
    jcfg = ref.configs.get_config(arch, smoke=True)
    cfg = tconfigs.get_config(arch, smoke=True)
    params = _j(numpy_params(cfg, 5))
    rng = np.random.default_rng(5)
    batch = {"tokens": jnp.asarray(rng.integers(0, jcfg.vocab, (b, s)),
                                   jnp.int32)}
    if jcfg.is_enc_dec:
        batch["enc_embeds"] = jnp.asarray(rng.standard_normal(
            (b, s // 4, jcfg.d_model)), jnp.float32)
    if jcfg.frontend == "vision":
        batch["prefix_embeds"] = jnp.asarray(rng.standard_normal(
            (b, jcfg.frontend_seq, jcfg.d_model)), jnp.float32)
    extra = jcfg.frontend_seq if jcfg.frontend == "vision" else 0
    logits, caches = ref.transformer.prefill(jcfg, params, batch,
                                             s + gen + extra)
    want = []
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    for i in range(gen):
        want.append(np.asarray(tok)[:, 0])
        logits, caches = ref.transformer.decode_step(
            jcfg, params, tok, caches,
            pos0=jnp.asarray(s + extra + i, jnp.int32))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    assert res.tokens.shape == (b, gen)
    assert np.array_equal(res.tokens, np.stack(want, axis=1))
