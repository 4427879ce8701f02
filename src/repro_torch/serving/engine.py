"""``ServeEngine``: continuous-batching inference over a fixed slot pool
(counterpart of ``repro/serving/engine.py``).

* **Fixed shapes.**  Prompts are right-padded to ``max_prompt`` and decode
  runs over all ``slots`` rows whether they are active or not, as in the
  reference.  Causal attention makes the pad lanes inert: the hidden state
  and KV rows at every true prompt position ignore them, and decode
  overwrites slot ``p`` at position ``p`` before its mask can admit it.
  The same argument covers slot reuse.
* **Continuous batching.**  The KV cache is one pooled buffer
  ``(layers, slots, CL, kv_heads, head_dim)``; each slot carries its own
  decode position (``attention_block``'s vector ``decode_pos``), so a
  finished request frees its slot and a new one claims it mid-decode.
* The prefill runs every layer's attention through the flash-attention
  kernel (on the card); decode is plain PyTorch.  The cache lies where the
  params lie and has their dtype.

Greedy (argmax) sampling over the stacked-transformer families ``dense``
and ``moe``: like the reference, the engine refuses the ``ssm`` family (its
recurrent cache has no per-slot decode adapter), which ``reference_decode``
serves, and the ``vlm`` family (its prefill needs patches).  An MoE
prefill drops tokens past each expert's capacity, which counts the pad
lanes of the right-padded prompt: the engine matches the unpadded oracle
only where no token is dropped (the reference's tests raise the capacity
factor for that).  The reference's ``compile_counts`` has no
counterpart: it counts jit executables, and the port runs eagerly with
nothing compiled per shape.  ``maybe_swap`` (hot param swap from a
``ParamStore``) is not ported yet.
``reference_decode`` is the sequential single-request oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import not_ported
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models import transformer as T

Params = Any

_SERVABLE_FAMILIES = ("dense", "moe")


def _first_leaf(params) -> torch.Tensor:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params


@dataclasses.dataclass
class FinishedRequest:
    """One completed request, as harvested from a slot."""
    rid: int
    tokens: List[int]          # all generated tokens (first from prefill)


class ServeEngine:
    """Continuous-batching prefill/decode engine over one model config.

    Shapes are fixed at construction: ``slots`` concurrent requests,
    prompts ``<= max_prompt``, prompt + generation ``<= max_seq``.  The
    engine runs where ``params`` lie (the card, or the CPU in tests).
    """

    def __init__(self, cfg: ModelConfig, params: Params, *, slots: int = 8,
                 max_prompt: int = 64, max_seq: int = 128,
                 params_version: int = 0):
        if cfg.family not in _SERVABLE_FAMILIES:
            raise NotImplementedError(
                f"ServeEngine serves the stacked-transformer families "
                f"{_SERVABLE_FAMILIES}; {cfg.family!r} needs a per-slot "
                f"decode adapter")
        if max_prompt > max_seq:
            raise ValueError(f"max_prompt={max_prompt} > max_seq={max_seq}")
        self.cfg = cfg
        self.slots = int(slots)
        self.max_prompt = int(max_prompt)
        self.max_seq = int(max_seq)
        self.CL = T.cache_len(cfg, max_seq)
        if self.CL < max_prompt:
            raise ValueError(
                f"rolling cache ({self.CL}) shorter than max_prompt "
                f"({max_prompt}): prefill would evict prompt KV")
        self.params = params
        self.params_version = int(params_version)
        leaf = _first_leaf(params)
        self.device = leaf.device
        self.cache = T.init_cache(cfg, self.slots, self.max_seq, leaf.dtype,
                                  self.device)
        # host-side slot table
        S = self.slots
        self.pos = np.zeros(S, np.int64)           # next decode position
        self.active = np.zeros(S, bool)
        self._next_tok = np.zeros(S, np.int64)     # last sampled token
        self._remaining = np.zeros(S, np.int64)    # decode steps left
        self._rid = [-1] * S
        self._out: List[List[int]] = [[] for _ in range(S)]
        self.last_logits: Optional[np.ndarray] = None   # (S, V) fp32

    # ------------------------------------------------------------------
    # the three programs of the reference: prefill, claim, decode
    # ------------------------------------------------------------------
    def _prefill(self, padded: np.ndarray, true_len: int):
        tokens = torch.from_numpy(padded[None]).to(self.device)
        hidden, cache = T.forward(self.cfg, self.params, tokens,
                                  return_cache=True, cache_seq=self.max_seq)
        logits = T.lm_logits(self.cfg, self.params, hidden[0, true_len - 1])
        return int(torch.argmax(logits)), cache

    def _claim(self, req_cache, slot: int) -> None:
        for name in ("k", "v"):
            self.cache[name][:, slot] = req_cache[name][:, 0]

    # ------------------------------------------------------------------
    # slot pool
    # ------------------------------------------------------------------
    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    @property
    def free_slots(self) -> int:
        return self.slots - self.num_active

    def submit(self, rid: int, prompt: np.ndarray, gen: int
               ) -> Optional[FinishedRequest]:
        """Prefill one request and claim a free slot for it.  Returns the
        completed request at once when ``gen == 1``; otherwise the request
        decodes in its slot until ``gen`` tokens exist.  Raises if no slot
        is free (callers gate on ``free_slots``)."""
        L = int(len(prompt))
        if not 1 <= L <= self.max_prompt:
            raise ValueError(f"prompt length {L} outside [1, "
                             f"{self.max_prompt}]")
        if gen < 1 or L + gen > self.max_seq:
            raise ValueError(f"prompt {L} + gen {gen} exceeds max_seq "
                             f"{self.max_seq}")
        free = np.nonzero(~self.active)[0]
        if not len(free):
            raise RuntimeError("no free slot; check free_slots before submit")
        slot = int(free[0])
        padded = np.zeros(self.max_prompt, np.int64)
        padded[:L] = np.asarray(prompt, np.int64)
        tok, req_cache = self._prefill(padded, L)
        if gen == 1:
            return FinishedRequest(rid, [tok])
        self._claim(req_cache, slot)
        del req_cache
        self.active[slot] = True
        self.pos[slot] = L
        self._next_tok[slot] = tok
        self._remaining[slot] = gen - 1
        self._rid[slot] = rid
        self._out[slot] = [tok]
        return None

    def step(self) -> List[FinishedRequest]:
        """One batched decode step over the whole slot pool (inactive slots
        compute too, fixed shapes, but their outputs are discarded).
        Returns the requests that finished this step."""
        if not self.active.any():
            return []
        tokens = torch.from_numpy(self._next_tok[:, None]).to(self.device)
        pos = torch.from_numpy(self.pos).to(self.device)
        logits, self.cache = T.decode_step(self.cfg, self.params, self.cache,
                                           tokens, pos)
        toks = torch.argmax(logits, -1).cpu().numpy()
        self.last_logits = logits.cpu().numpy()
        finished: List[FinishedRequest] = []
        for s in np.nonzero(self.active)[0]:
            self._out[s].append(int(toks[s]))
            self._next_tok[s] = toks[s]
            self.pos[s] += 1
            self._remaining[s] -= 1
            if self._remaining[s] == 0:
                finished.append(FinishedRequest(self._rid[s], self._out[s]))
                self.active[s] = False
                self._rid[s] = -1
                self._out[s] = []
        return finished

    def maybe_swap(self, store) -> bool:
        raise not_ported("hot param swap (ServeEngine.maybe_swap, "
                         "ParamStore)", "Hot swap")


# =============================================================================
# sequential single-request oracle
# =============================================================================
def reference_decode(cfg: ModelConfig, params: Params, prompt: np.ndarray,
                     gen: int, *, return_margins: bool = False):
    """Greedy decode of ONE request, unpadded and unbatched: prefill, then
    scalar-position decode steps, for any ported family (the only way the
    ``ssm`` family is served).  The continuous-batching engine must match
    it token for token.  With ``return_margins`` also returns, for each
    token, the gap between the top two logits it was chosen from (a token
    chosen under a near-tie may flip under another summation order)."""
    device = _first_leaf(params).device
    L = int(len(prompt))
    tokens = torch.as_tensor(np.asarray(prompt, np.int64)[None],
                             device=device)
    logits, cache = api.prefill(cfg, params, {"tokens": tokens},
                                target_seq=L + gen)
    out, margins = [], []
    for i in range(gen):
        if i:
            logits, cache = api.decode(cfg, params, cache, token, L + i - 1)
        token = torch.argmax(logits, -1)[:, None]
        out.append(int(token[0, 0]))
        if return_margins:
            top2 = torch.topk(logits[0], 2).values
            margins.append(float(top2[0] - top2[1]))
    return (out, margins) if return_margins else out
