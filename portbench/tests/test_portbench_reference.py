"""The plain reference against the port at ``tiny`` in float32 on the CPU,
and its decode rules against the port's."""

import numpy as np
import pytest
import torch

from portbench import reference, spec
from portbench.tests import tiny
from portbench.weights import Dims, make_weights

DIMS = Dims.from_config({**tiny.TINY, "max_source_positions": 1500, "max_target_positions": 448})


def test_vocab_rules_are_the_ports():
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.sampling import build_suppress_ids
    from whisper_tpu_torch.tokenizer import find_vocab_file, get_tokenizer

    frozen = reference.load_vocab_rules()
    assert reference.vocab_rules(reference.bpe_ranks(find_vocab_file())) == frozen
    ids = build_suppress_ids(get_config("turbo"), get_tokenizer(num_languages=100))
    assert sorted(int(i) for i in ids if i < 50257) == frozen["non_speech"]
    assert get_tokenizer(num_languages=100).encode(" ")[0] == frozen["blank"]


@pytest.mark.parametrize("seconds", [30.0, 4.3])
def test_mel_is_the_ports(seconds):
    from whisper_tpu_torch.ops.mel import log_mel_batch

    n = int(seconds * 16000)
    audio = torch.zeros(1, reference.N_SAMPLES)
    audio[0, :n] = torch.randn(n, generator=torch.Generator().manual_seed(3)) * 0.1
    got = log_mel_batch(audio, torch.tensor([n]), n_mels=80)
    want = reference.log_mel(audio, [n], 80)
    assert (got - want).abs().max() < 1e-4


def test_encoder_and_logits_are_the_ports():
    from whisper_tpu_torch.models.model import (compute_cross_kv, decoder_forward,
                                                encoder_forward, new_kv_cache)

    torch.manual_seed(0)
    mel = torch.randn(2, 80, 3000) * 0.5
    tokens = torch.randint(0, 50257, (2, 12))
    port = spec.family("whisper").port_model(DIMS, {"name": "tiny"}, 7, "cpu")
    ref = reference.Reference(DIMS, make_weights(DIMS, 7, "cpu"))
    with torch.no_grad():
        audio = encoder_forward(port, mel, torch.float32)
        want_audio = ref.encode(mel)
        assert (audio - want_audio).abs().max() < 1e-3
        kv = new_kv_cache(port, 2, torch.float32, 128)
        got, _ = decoder_forward(port, tokens, 0, kv, compute_cross_kv(port, audio))
        want = ref.logits(want_audio, tokens)
    assert (got - want).abs().max() < 1e-3


@pytest.mark.parametrize("workload", ["turbo-offline-b64", "turbo-serve-poisson"])
def test_fp32_port_serves_the_references_tokens(workload):
    result = tiny.run(workload)
    assert result["correct"] and result["judge"]["tokens"] > 0
    assert result["checks"]["max_logit_gap"]["value"] < 1e-3
    assert result["checks"]["max_logprob_error"]["value"] < 1e-4
