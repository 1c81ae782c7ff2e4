"""Models of the port: the decoder stacks (``DecoderLM``) and the
whisper encoder-decoder (``WhisperModel``)."""
from .lm import DecoderLM  # noqa: F401
from .whisper import WhisperModel  # noqa: F401


def build_model(cfg, device=None, **kw):
    """The model class of ``cfg`` (the reference's ``build_model``);
    ``kw`` goes to ``DecoderLM`` (``wkv_prefill``)."""
    if cfg.is_encoder_decoder:
        return WhisperModel(cfg, device=device)
    return DecoderLM(cfg, device=device, **kw)


def param_specs(cfg) -> dict:
    """The parameter spec tree of ``cfg``'s model."""
    if cfg.is_encoder_decoder:
        from .whisper import param_specs as specs
    else:
        from .lm import param_specs as specs
    return specs(cfg)
