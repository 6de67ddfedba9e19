"""The port's jax-free copies give what their ``p2p_tpu`` originals give:
tokenizer, word/alignment helpers, configs and layouts, checkpoint name
tables, and the controller factory's parameters."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from p2p_tpu.align import aligner as j_aligner, words as j_words  # noqa: E402
from p2p_tpu.controllers import factory as jfactory  # noqa: E402
from p2p_tpu.models import checkpoint as j_ck, config as j_config  # noqa: E402
from p2p_tpu.utils import tokenizer as j_tok  # noqa: E402

from p2p_tpu_torch.align import aligner as p_aligner, words as p_words  # noqa: E402
from p2p_tpu_torch.controllers import factory as pfactory  # noqa: E402
from p2p_tpu_torch.models import checkpoint as p_ck, config as p_config  # noqa: E402
from p2p_tpu_torch.utils import tokenizer as p_tok  # noqa: E402

PROMPT_SETS = [
    ["a cat sitting on a car", "a dog sitting on a car"],
    ["a photo of a house on a mountain",
     "a photo of a house on a mountain at winter"],
    ["a squirrel eating a burger", "a lion eating a burger",
     "a hippopotamus eating a burger"],        # 'hippopotamus' splits in two
]


def _toks(max_len=77):
    return (j_tok.HashWordTokenizer(model_max_length=max_len),
            p_tok.HashWordTokenizer(model_max_length=max_len))


def test_tokenizer_ids_padding_and_strings():
    jt, pt = _toks()
    for prompts in PROMPT_SETS:
        for p in prompts:
            assert pt.encode(p) == jt.encode(p)
            assert p_tok.token_strings(pt, p) == j_tok.token_strings(jt, p)
        assert pt(prompts) == jt(prompts)
    ids = list(range(90))
    assert p_tok.pad_ids(ids, 77, 1) == j_tok.pad_ids(ids, 77, 1)
    assert p_tok.pad_ids(ids[:5], 77, 1) == j_tok.pad_ids(ids[:5], 77, 1)
    js, ps = (m.HashWordTokenizer(sequential=True) for m in (j_tok, p_tok))
    assert [ps.encode(p) for p in PROMPT_SETS[2]] == [js.encode(p) for p in PROMPT_SETS[2]]


@pytest.mark.parametrize("max_len", [77, 16])
def test_mappers_and_alphas(max_len):
    jt, pt = _toks(max_len)
    for prompts in PROMPT_SETS:
        if len(prompts[0].split()) == len(prompts[1].split()):
            np.testing.assert_array_equal(
                p_aligner.get_replacement_mapper(prompts, pt, max_len=max_len),
                j_aligner.get_replacement_mapper(prompts, jt, max_len=max_len))
        for got, want in zip(
                p_aligner.get_refinement_mapper(prompts, pt, max_len=max_len),
                j_aligner.get_refinement_mapper(prompts, jt, max_len=max_len)):
            np.testing.assert_array_equal(got, want)
        for bounds in (0.8, (0.2, 0.6), {"default_": 0.8, "car": 0.3}):
            np.testing.assert_array_equal(
                p_words.get_time_words_attention_alpha(
                    prompts, 10, bounds, pt, max_num_words=max_len),
                j_words.get_time_words_attention_alpha(
                    prompts, 10, bounds, jt, max_num_words=max_len))
        np.testing.assert_array_equal(
            p_words.get_word_inds(prompts[0], "a", pt),
            j_words.get_word_inds(prompts[0], "a", jt))
    np.testing.assert_array_equal(
        p_words.get_equalizer("a dog on a car", ["dog"], [2.5], pt, mode="paired"),
        j_words.get_equalizer("a dog on a car", ["dog"], [2.5], jt, mode="paired"))


@pytest.mark.parametrize("mode", ["replace", "refine"])
def test_factory_parameters(mode):
    jt, pt = _toks()
    prompts = PROMPT_SETS[0] if mode == "replace" else PROMPT_SETS[1]
    kw = dict(is_replace_controller=mode == "replace", cross_replace_steps=0.8,
              self_replace_steps=0.4, num_steps=50)
    jc = jfactory.make_controller(prompts, tokenizer=jt, **kw)
    pc = pfactory.make_controller(prompts, tokenizer=pt, **kw)
    je, pe = jc.edit, pc.edit
    assert (pe.kind, pe.self_max_pixels, pc.store) == (je.kind, je.self_max_pixels, jc.store)
    assert (pe.self_start, pe.self_end) == (int(je.self_start), int(je.self_end))
    for name in ("cross_alpha", "mapper", "refine_alphas"):
        got, want = getattr(pe, name), getattr(je, name)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # LocalBlend and Reweight on top: the same masks and equalizer.
    extra = dict(blend_words=[["car"]] * 2,
                 equalizer_params={"words": ("car",), "values": (2.0,)})
    jc = jfactory.make_controller(prompts, tokenizer=jt, **extra, **kw)
    pc = pfactory.make_controller(prompts, tokenizer=pt, **extra, **kw)
    np.testing.assert_array_equal(pc.edit.equalizer.numpy(), np.asarray(jc.edit.equalizer))
    np.testing.assert_array_equal(pc.blend.alpha_layers.numpy(),
                                  np.asarray(jc.blend.alpha_layers))
    assert (pc.edit.kind, pc.blend.start_blend) == (jc.edit.kind, int(jc.blend.start_blend))


def test_configs_and_layouts():
    for name in ("SD14", "TINY", "SD21_TEXT", "SD21_UNET", "SD21_BASE", "SD21"):
        jc, pc = getattr(j_config, name), getattr(p_config, name)
        assert dataclass_dict(pc) == dataclass_dict(jc)
        if not hasattr(pc, "unet"):
            continue
        assert p_config.unet_attn_specs(pc.unet) == j_config.unet_attn_specs(jc.unet)
        assert (p_config.unet_layout(pc.unet).metas
                == tuple(_same_meta(m) for m in j_config.unet_layout(jc.unet).metas))
    assert len(p_config.unet_attn_specs(p_config.SD14.unet)) == 32
    assert {n: dataclass_dict(c) for n, c in p_config.PRESET_CONFIGS.items()} == {
        n: dataclass_dict(j_config.PRESET_CONFIGS[n]) for n in p_config.PRESET_CONFIGS}


def dataclass_dict(obj):
    import dataclasses

    if dataclasses.is_dataclass(obj):
        return {f.name: dataclass_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return obj


def _same_meta(m):
    from p2p_tpu_torch.controllers.base import AttnMeta

    return AttnMeta(m.layer_idx, m.place, m.is_cross, m.resolution, m.heads,
                    m.key_len, m.store_slot, m.channels)


@pytest.mark.parametrize("preset", ["SD14", "TINY", "SD21", "SD21_BASE"])
def test_checkpoint_name_tables(preset):
    jc, pc = getattr(j_config, preset), getattr(p_config, preset)
    assert p_ck.unet_entries(pc.unet) == j_ck.unet_entries(jc.unet)
    assert p_ck.text_encoder_entries(pc.text) == j_ck.text_encoder_entries(jc.text)
    assert p_ck.vae_entries(pc.vae) == j_ck.vae_entries(jc.vae)
    # The random init makes exactly the named weights (shapes are held
    # against the JAX init at TINY in test_torch_modules.py).
    for init, entries, cfg in ((p_ck.init_unet, p_ck.unet_entries, pc.unet),
                               (p_ck.init_text_encoder, p_ck.text_encoder_entries, pc.text),
                               (p_ck.init_vae, p_ck.vae_entries, pc.vae)):
        assert set(init(cfg, None, "meta")) == {name for _, name, _ in entries(cfg)}
