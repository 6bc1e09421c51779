"""Multi-tenant model registry: named packed models behind one fabric.

MENAGE's central trick is the *virtual neuron* — one physical neuron engine
time-multiplexes many model neurons by exploiting event sparsity.  The
serving stack applies the same idea one level up: one always-on
:class:`~repro_torch.engine.stream_server.StreamServer` ("the fabric")
time-multiplexes many *models*.  This module is the bookkeeping layer that
makes that safe:

  * :class:`ModelEntry` — one tenant: a :class:`PackedModel` on its device
    (plus its clean twin when serving-time analog noise is configured), the
    tenant's own :class:`~repro_torch.engine.serving.BucketPolicy`, a
    weighted-fair scheduling ``weight``, and a monotonically increasing
    ``generation`` — the hot-swap epoch counter.
  * :class:`ModelRegistry` — named entries with **atomic replacement**
    semantics: :meth:`swap` installs a new generation in one assignment, so
    a concurrent reader sees either the old entry or the new one, never a
    half-built tenant.  The registry itself never touches in-flight work;
    the server's :meth:`~repro_torch.engine.stream_server.StreamServer.swap`
    drains pending dispatches on the old weights *before* calling it, and
    every admitted request pins the entry (name, generation) it was
    admitted under — so even a registry swapped out from underneath the
    scheduler cannot corrupt a queued request.

Entries are plain frozen data; everything mutable (runtime bucket policies,
EWMA service estimates, fair-queueing virtual time) lives on the server.
"""

from __future__ import annotations

import dataclasses

from repro_torch.engine import batched_run as br
from repro_torch.engine.serving import BucketPolicy

#: The tenant name single-model servers (and model-less submits) are
#: routed to.
DEFAULT_MODEL = "default"

# sentinel: "inherit the old entry's noise config" on swap
_KEEP = object()


class UnknownModelError(KeyError):
    """A submit/swap referenced a model name the registry does not hold —
    transports map this to a reasoned rejection instead of crashing."""

    def __init__(self, name: str, known):
        self.name = name
        self.known = tuple(known)
        super().__init__(name)

    def __str__(self) -> str:
        return (f"unknown model {self.name!r} "
                f"(registered: {', '.join(self.known) or 'none'})")


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    """One tenant of the serving fabric (immutable; swaps replace it)."""

    name: str
    packed: br.PackedModel          # the weights requests are served on
    clean: br.PackedModel           # un-perturbed twin (== packed w/o noise)
    policy: BucketPolicy            # the tenant's admission-time bucket grid
    noise: object | None = None     # AnalogNoise or None
    weight: float = 1.0             # weighted-fair scheduling share
    generation: int = 1             # hot-swap epoch, bumps on every swap


def _build_entry(name: str, model, *, policy: BucketPolicy | None,
                 noise=None, noise_key=0, weight: float = 1.0,
                 generation: int = 1, device="cuda") -> ModelEntry:
    packed = (model if isinstance(model, br.PackedModel)
              else model.pack(device=device))
    clean = packed
    if noise is not None and noise.weight_sigma > 0:
        from repro_torch.core.noise import as_noise_key, perturb_packed
        packed = perturb_packed(as_noise_key(noise_key), packed, noise)
    else:
        # weight_sigma <= 0 perturbs nothing: normalize to "noise off" so
        # the server's probe gate means "a perturbed model is serving"
        noise = None
    if not (isinstance(weight, (int, float)) and weight > 0):
        raise ValueError(f"model {name!r}: scheduling weight must be a "
                         f"positive number, got {weight!r}")
    return ModelEntry(name=name, packed=packed, clean=clean,
                      policy=policy if policy is not None else BucketPolicy(),
                      noise=noise, weight=float(weight),
                      generation=generation)


class ModelRegistry:
    """Named :class:`ModelEntry` map with atomic hot-swap semantics.

    ``register`` adds a tenant (duplicate names raise — replacing weights
    is a :meth:`swap`, which keeps the generation history honest).  The
    first registered tenant becomes the default route unless ``default=``
    names another; model-less submits go there.  A mapped model given to
    :meth:`register` or :meth:`swap` is packed onto ``device`` (default
    the card; ``device="cpu"`` for the plain path).
    """

    def __init__(self, *, default: str | None = None, device="cuda"):
        self._entries: dict[str, ModelEntry] = {}
        self._default = default
        self.device = device

    # ------------------------------------------------------------- queries

    @property
    def default(self) -> str:
        # an explicit default that has not (yet) been registered must not
        # strand routing — fall back to insertion order until it shows up
        if self._default is not None and self._default in self._entries:
            return self._default
        if not self._entries:
            raise UnknownModelError(self._default or DEFAULT_MODEL, ())
        return next(iter(self._entries))

    def names(self) -> tuple[str, ...]:
        return tuple(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get(self, name: str | None = None) -> ModelEntry:
        """The entry for ``name`` (``None`` = the default route)."""
        if name is None:
            name = self.default
        try:
            return self._entries[name]
        except KeyError:
            raise UnknownModelError(name, self._entries) from None

    # ----------------------------------------------------------- mutations

    def register(self, name: str, model, *, policy: BucketPolicy | None = None,
                 noise=None, noise_key=0, weight: float = 1.0) -> ModelEntry:
        """Add a tenant.  ``model`` is a ``PackedModel`` or anything with a
        ``.pack()``; ``policy`` defaults to a fresh :class:`BucketPolicy`.
        ``noise`` serves the tenant through one deterministic noisy device
        instance (the clean twin is kept for shadow probes)."""
        if not name:
            raise ValueError("model name must be non-empty")
        if name in self._entries:
            raise ValueError(f"model {name!r} is already registered — "
                             f"hot-swapping weights is swap(), not register()")
        entry = _build_entry(name, model, policy=policy, noise=noise,
                             noise_key=noise_key, weight=weight,
                             device=self.device)
        self._entries[name] = entry
        return entry

    def swap(self, name: str, model, *, policy: BucketPolicy | None = None,
             noise=_KEEP, noise_key=0, weight: float | None = None
             ) -> ModelEntry:
        """Atomically replace ``name``'s entry with a new generation.

        Everything not given is inherited from the old entry (policy,
        noise config, weight), so the common call is just ``swap(name,
        new_packed)``.  The single-assignment replacement is the atomicity
        guarantee: readers see old or new, never a mix.  Draining in-flight
        work on the old weights is the *server's* job
        (:meth:`StreamServer.swap`) — a bare registry swap only redirects
        future lookups."""
        old = self.get(name)
        entry = _build_entry(
            name, model,
            policy=policy if policy is not None else old.policy,
            noise=(old.noise if noise is _KEEP else noise),
            noise_key=noise_key,
            weight=weight if weight is not None else old.weight,
            generation=old.generation + 1, device=self.device)
        self._entries[name] = entry     # the atomic redirect
        return entry
