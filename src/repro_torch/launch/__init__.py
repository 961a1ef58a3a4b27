"""Command-line entry points of the port."""


def require_token_inputs(cfg, cli: str) -> None:
    """Refuse, by name, a config whose inputs are more than tokens: these CLIs feed tokens
    alone, as the reference's do. An encoder-decoder (``frames``) or a VLM
    (``patch_embeds``) is served through ``build(cfg).prefill`` and ``decode_step``."""
    inputs = (("frames", cfg.is_encdec), ("patch_embeds", cfg.frontend == "vision_stub"))
    extra = [name for name, takes in inputs if takes]
    if extra:
        raise SystemExit(
            f"{cli}: {cfg.name} takes {' and '.join(extra)} beside its tokens, and this CLI "
            f"feeds tokens alone, as the reference's does; serve {cfg.name} through "
            "build(cfg).prefill and decode_step"
        )
