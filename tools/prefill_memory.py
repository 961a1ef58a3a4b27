"""Where a recurrentgemma-9b prefill holds its device memory, on one NVIDIA card.

    python3 tools/prefill_memory.py

Builds recurrentgemma-9b at full width and depth with ``chip_smoke.py``'s
seeded weights and prefills its longest prompt (r5 of
``chip_smoke.hybrid_prompts``, 2,823 tokens) as the batcher does (padded to
3,072). Every call of the model's blocks (the norms, the recurrent block and
inside it the causal conv and the RG-LRU scan, the attention block and its
cache rebuild, the MLP) is timed for memory: the bytes allocated when it
starts and its peak above them (``torch.cuda.max_memory_allocated`` after a
reset at its start). Prints, for each block, the largest peak over the
prefill with the bytes held at its start, and the prefill's own peak above
the weights. It only reports; it checks nothing. It needs a card and a
checkout of the repository.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build, rglru, transformer  # noqa: E402
from repro_torch.params import init_params  # noqa: E402

DEV = cs.DEV
# (module, function name): the blocks whose memory is recorded
BLOCKS = (
    (transformer, "apply_layer"),
    (transformer, "apply_norm"),
    (transformer, "recurrent_block"),
    (transformer, "gqa_attention"),
    (transformer, "_prefill_cache_from_full"),
    (transformer, "glu_mlp"),
    (rglru, "_causal_conv1d"),
    (rglru.ops, "rglru"),
)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("prefill_memory: torch.cuda.is_available() is False; it needs a card")
    cs.phase_device()
    cfg = get_config("recurrentgemma-9b")
    params = init_params(cfg, cs._gen(0), DEV)
    model = build(cfg, DEV)
    prompt = max(cs.hybrid_prompts(cfg.vocab_size), key=len)
    ids = torch.as_tensor(prompt, dtype=torch.long, device=DEV)[None]
    model.prefill(params, {"tokens": ids[:, :64]})  # warm-up: kernels built and loaded
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()

    worst = {}  # block -> (peak above its start, bytes held at its start)
    stack = []

    def recorded(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            stack.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            # the enclosing block's peak: the larger of its peak before this call and
            # this call's, brought back by allocating up to it for a moment
            outer = max(stack.pop(), peak)
            torch.cuda.reset_peak_memory_stats()
            pad = torch.empty(outer - torch.cuda.memory_allocated(), dtype=torch.uint8, device=DEV)
            del pad
            if peak - start > worst.get(name, (-1, 0))[0]:
                worst[name] = (peak - start, start)
            return out

        return call

    for module, name in BLOCKS:
        setattr(module, name, recorded(name, getattr(module, name)))
    torch.cuda.reset_peak_memory_stats()
    model.prefill(params, {"tokens": ids}, pad_to=cs.HYBRID_MAX_LEN)
    torch.cuda.synchronize()
    total = torch.cuda.max_memory_allocated()
    cs.log(
        f"[memory] recurrentgemma-9b prefill of {len(prompt)} tokens (padded to "
        f"{cs.HYBRID_MAX_LEN}): peak {total} bytes, {total - weights} above the {weights} held "
        "after building the model"
    )
    for name, (above, start) in sorted(worst.items(), key=lambda kv: -kv[1][0]):
        cs.log(
            f"[memory]   {name}: peak {above} bytes above its start ({above / len(prompt):.0f} "
            f"a token), {start - weights} bytes held above the weights at its start"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
