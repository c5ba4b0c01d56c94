"""The comparison that decides ``correct``: at every served token of the
sampled requests, the gap by which its logit lies below the reference's
best logit at its position. A greedy stream of a sound program only picks
a token the reference ranks first or within rounding of first; a wrong
token, cache or step reads as a gap of the logits' spread (several units
at these weights). Two numbers are taken from the gaps: the widest
(``logit_gap``) and their mean over the served tokens (``mean_gap``); a
cell compares those its file gives a limit."""

from __future__ import annotations

import torch

__all__ = ["served_sequence", "token_gaps", "numbers"]


def served_sequence(prompt, served, device) -> tuple[torch.Tensor, int]:
    """(tokens, start) for ``reference.model.logits_at``: the prompt as the
    program ran it followed by every served token but the last; row
    ``start + j`` predicts served token j."""
    tokens = torch.cat([torch.as_tensor(prompt, dtype=torch.long),
                        torch.as_tensor(served[:-1], dtype=torch.long)])
    return tokens.to(device), len(prompt) - 1


def token_gaps(ref_logits: torch.Tensor, tokens) -> torch.Tensor:
    """(n,) the reference's best logit less its logit of each row's token;
    ``tokens`` (n,) are the served tokens, or the tokens a control puts
    first."""
    t = torch.as_tensor(tokens, dtype=torch.long, device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(1, t[:, None])[:, 0]


def numbers(gaps: list[torch.Tensor]) -> dict:
    """``logit_gap`` and ``mean_gap`` over every token of the requests'
    gaps (one tensor a request)."""
    g = torch.cat([x.float().cpu() for x in gaps])
    return {"logit_gap": float(g.max()), "mean_gap": float(g.mean())}
