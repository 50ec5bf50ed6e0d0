"""What every traffic kind (``perfbench/generators/<kind>.py``) provides.

A kind reads its parameters from ``perfbench/traffic/<mix>.json``. Sizes
(durations, lengths) are fixed lists in that file, served in that order
in every run; the seed draws the content: the weights, the audio, the
texts. So every seed does the same amount of work and the window's rate
moves with the program, not with the draw.
"""
from contextlib import nullcontext
from typing import Dict, List

import numpy as np

from . import audio as audio_mod
from .ranks import N_BASE


def no_span(name, sync=True):
    return nullcontext()


class Workload:
    """One traffic mix on one configuration, driven from one seed."""

    kind = None     # the traffic kind, the module's name

    def __init__(self, params: dict, dims: dict, seed: int, device):
        self.params = params
        self.dims = dims
        self.seed = int(seed)
        self.device = device
        self.served: List[dict] = []     # one record per finished request
        self.eot = N_BASE                # the rank table's first special id
        self.span = no_span              # the tracer's span in a traced run

    # -- inputs ----------------------------------------------------------------------------

    def sizes(self) -> List[dict]:
        """The fixed list of request sizes, in serving order."""
        raise NotImplementedError

    def make_request(self, i: int) -> dict:
        """Request ``i`` (sizes cycle): its inputs, made from the seed."""
        sizes = self.sizes()
        size = sizes[i % len(sizes)]
        speech = audio_mod.speech_like(size['seconds'], (self.seed, i), self.device)
        return dict(index=i, speech=speech, audio_s=speech.seconds, **size)

    def rng(self, *salt) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            audio_mod.seed_words((self.seed, *salt))))

    # -- the program -------------------------------------------------------------------

    def warmup(self, model) -> None:
        raise NotImplementedError

    def serve(self, model, req: dict) -> dict:
        """Serve one request through the program's entry and render its
        SRT; returns what the readers and the check need of it."""
        raise NotImplementedError

    def install(self, model) -> None:
        """Record the program's outputs during the window (every run)."""

    def uninstall(self, model) -> None:
        pass

    def trace_hooks(self, tracer, model) -> None:
        """Install the kind's spans and counters (traced runs only)."""

    def useful_flops(self) -> float:
        """Model operations of the useful work of the served requests."""
        return 0.0

    def real_windows(self) -> int:
        return 0

    # -- correctness ---------------------------------------------------------------------

    def sample(self) -> List[dict]:
        """The program's outputs to judge, drawn from the seed."""
        raise NotImplementedError

    def check(self, judge, items: List[dict]) -> Dict[str, float]:
        """The compared numbers of ``items`` read by ``judge``."""
        raise NotImplementedError

    def control(self, control_judge, items: List[dict]) -> List[dict]:
        """``items`` with the program's outputs replaced by the control's."""
        raise NotImplementedError
