"""Launches of `samples_per_launch` at the configuration's camera,
accumulated into one image, as a user converging a still.  The seed sets
the subframe the window starts from, which is the counter of every
sample's random numbers.  The check compares the final accumulation."""

from __future__ import annotations


def subframe(tr, k: int) -> int:
    return tr.start_subframe + k


def eye(tr, k: int):
    return tuple(float(x) for x in tr.camera["eye"])


class Loop:
    def __init__(self, tr, r, program, device):
        self.r, self.pix = r, tr.pixels_on(device)

    def launch(self, k: int, spans=None):
        return self.r.step()

    def keep(self, img) -> None:
        pass

    def values(self):
        """[1,P,3]: the accumulation at the checked pixels."""
        return self.r.accum.reshape(-1, 3)[self.pix][None].cpu().numpy()


def expected(per_launch, tr, ref):
    """The reference's [L,P,3] launch means folded as the film folds them."""
    return ref.accumulate(list(per_launch), tr.spp)[None]
