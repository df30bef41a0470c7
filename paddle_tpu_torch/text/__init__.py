"""``paddle.text``: the counterpart of ``paddle_tpu/text/__init__.py``
(the datasets over local archives, ``viterbi_decode`` and
``ViterbiDecoder``).

The Viterbi recursion is JAX's: scores [B, N] start at the first step's
potentials, each step takes the max over the previous tag of score +
transition + potential (argmax ties to the lower tag, as ``jnp.argmax``),
and the best path is traced back through the argmax history. As in the
JAX package, ``lengths`` and ``include_bos_eos_tag`` are taken and not
applied: every sequence runs its full T steps. It runs on the
potentials' device, one small reduction a step.
"""

import torch

from .datasets import (Conll05st, Imdb, Imikolov, Movielens,  # noqa: F401
                       UCIHousing, WMT14, WMT16)


def viterbi_decode(potentials, transitions, lengths=None,
                   include_bos_eos_tag=True, name=None):
    """(best scores [B], best paths [B, T] int64) of potentials [B, T, N]
    under transitions [N, N]."""
    return ViterbiDecoder(transitions, include_bos_eos_tag)(potentials,
                                                            lengths)


class ViterbiDecoder:
    def __init__(self, transitions, include_bos_eos_tag=True):
        self.transitions = transitions

    def __call__(self, potentials, lengths):
        trans, pot = self.transitions, potentials
        T = pot.shape[1]
        score = pot[:, 0]
        hist = []
        for t in range(1, T):
            all_scores = score[:, :, None] + trans[None] + pot[:, t, None, :]
            hist.append(torch.argmax(all_scores, dim=1))
            score = all_scores.amax(dim=1)
        best_last = torch.argmax(score, dim=-1)
        path = [best_last]
        for h in reversed(hist):
            best_last = torch.gather(h, 1, best_last[:, None])[:, 0]
            path.append(best_last)
        return score.max(dim=-1).values, torch.stack(path[::-1], dim=1)


__all__ = ["viterbi_decode", "ViterbiDecoder", "Imdb", "Imikolov",
           "UCIHousing", "Conll05st", "Movielens", "WMT14", "WMT16"]
