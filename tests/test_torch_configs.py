"""The port's config dataclasses equal the JAX package's, field for field."""

import dataclasses

import pytest

import unispeech_tpu.configs as jc
import unispeech_tpu_torch.configs as tc

REF_DICT = dict(
    encoder_layers=3, encoder_embed_dim=96, encoder_attention_heads=4,
    conv_feature_layers="[(64,10,5)] + [(64,3,2)] * 2", conv_pos=16,
    conv_pos_groups=4, relative_position_embedding=True, num_buckets=32,
    max_distance=64, gru_rel_pos=True, mask_prob=0.5, mask_channel_prob=0.1,
    unknown_field=1,
)


@pytest.mark.parametrize("build", [
    lambda m: m.base_encoder_config(),
    lambda m: m.large_encoder_config(),
    lambda m: m.base_encoder_config(relative_position_embedding=True, gru_rel_pos=True),
    lambda m: m.WavLMModelConfig(),
    lambda m: m.WavLMModelConfig.from_reference_dict(REF_DICT),
    lambda m: m.HubertPretrainConfig(),
    lambda m: m.Wav2Vec2PretrainConfig(),
], ids=["base", "large", "base_plus", "wavlm", "from_reference", "hubert", "wav2vec2"])
def test_configs_equal(build):
    assert dataclasses.asdict(build(tc)) == dataclasses.asdict(build(jc))


def test_derived_values_equal():
    for enc_t, enc_j in ((tc.base_encoder_config(), jc.base_encoder_config()),
                         (tc.large_encoder_config(), jc.large_encoder_config())):
        assert enc_t.frame_hop == enc_j.frame_hop
        assert enc_t.frame_receptive_field == enc_j.frame_receptive_field
        assert [enc_t.num_frames(n) for n in (400, 16000, 256000)] == [
            enc_j.num_frames(n) for n in (400, 16000, 256000)]
    spec = "[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2"
    assert tc.eval_conv_spec(spec) == jc.eval_conv_spec(spec)
    with pytest.raises(ValueError):
        tc.eval_conv_spec("__import__('os')")
    vq_t, vq_j = tc.GumbelVQConfig(), jc.GumbelVQConfig()
    for n in (0, 1000, 10**6):
        assert vq_t.temp_at(n) == pytest.approx(float(vq_j.temp_at(n)), rel=1e-6)
