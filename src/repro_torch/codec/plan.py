"""Per-layer compression plans: the port of `repro.codec.plan` (pure Python).

A frozen `LayerPolicy` (keep/bits/enabled/codec) plus a `CompressionPlan`
that resolves one policy per layer index.  Spec strings, segments and the
byte accounting are the JAX package's, so a plan parses and sizes a pool
identically in both ports.  The budget solver (`from_budget`) is a later
slice; so are codec backends — the port's path follows the tensor's device.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

BLOCK = 8
KEEP_MIN, KEEP_MAX = 1, BLOCK


@dataclass(frozen=True)
class LayerPolicy:
    """keep: kept k x k low-frequency DCT corner (1..8); bits: step-1
    integer precision of the paper scheme; enabled=False stores the full
    8x8 corner; codec: the codec family storing this layer's blocks."""

    keep: int = 4
    bits: int = 8
    enabled: bool = True
    codec: str = "dct"

    def __post_init__(self):
        if not KEEP_MIN <= self.keep <= KEEP_MAX:
            raise ValueError(f"keep must be in [{KEEP_MIN}, {KEEP_MAX}], got {self.keep}")
        if not 1 <= self.bits <= 16:
            raise ValueError(f"bits must be in [1, 16], got {self.bits}")
        from repro_torch.codec import families as families_lib

        families_lib.get_family(self.codec)  # raises for unported/unknown

    @property
    def kv_keep(self) -> int:
        """Corner size in the compressed KV store (a disabled layer keeps
        the full 8x8 corner: int8 quantization only)."""
        return self.keep if self.enabled else KEEP_MAX


Rule = tuple[int, "int | None", LayerPolicy]


@dataclass(frozen=True)
class CompressionPlan:
    """Resolves a `LayerPolicy` per layer index; rules are (start, stop,
    policy), stop=None open-ended, first match wins."""

    rules: tuple[Rule, ...] = ()
    default: LayerPolicy = LayerPolicy()

    def policy(self, idx: int) -> LayerPolicy:
        for start, stop, pol in self.rules:
            if idx >= start and (stop is None or idx < stop):
                return pol
        return self.default

    def policies(self, n_layers: int) -> tuple[LayerPolicy, ...]:
        return tuple(self.policy(i) for i in range(n_layers))

    def keeps(self, n_layers: int) -> tuple[int, ...]:
        return tuple(p.keep for p in self.policies(n_layers))

    def segments(self, n_layers: int, start: int = 0):
        """Contiguous (start, stop, policy) runs of equal policy covering
        [start, n_layers)."""
        assert start < n_layers, (start, n_layers)
        out = []
        s0, pol = start, self.policy(start)
        for i in range(start + 1, n_layers):
            p = self.policy(i)
            if p != pol:
                out.append((s0, i, pol))
                s0, pol = i, p
        out.append((s0, n_layers, pol))
        return tuple(out)

    @classmethod
    def uniform(cls, keep: int = 4, bits: int = 8,
                enabled: bool = True) -> "CompressionPlan":
        pol = LayerPolicy(keep=keep, bits=bits, enabled=enabled)
        return cls(rules=((0, None, pol),), default=pol)

    # "0-3:keep=6,4-:keep=3" — comma-separated RANGE:SETTINGS entries, the
    # JAX package's grammar; parse errors name the token and its position.
    _RANGE = re.compile(r"^(\d+)(-(\d*))?$")

    @classmethod
    def from_spec(cls, spec: str) -> "CompressionPlan":
        def fail(token: str, pos: int, why: str):
            raise ValueError(f"bad plan spec token {token!r} at position "
                             f"{pos} in {spec!r}: {why}")

        rules = []
        cursor = 0
        for entry in spec.split(","):
            entry_pos = cursor + len(entry) - len(entry.lstrip())
            cursor += len(entry) + 1
            entry = entry.strip()
            if not entry:
                continue
            rng, sep, settings = entry.partition(":")
            m = cls._RANGE.match(rng.strip())
            if not m or not sep:
                fail(entry, entry_pos, "want RANGE:SETTINGS, e.g. '0-3:keep=6'")
            start = int(m.group(1))
            if m.group(2) is None:
                stop: int | None = start + 1
            else:
                stop = int(m.group(3)) + 1 if m.group(3) else None
            if stop is not None and stop <= start:
                fail(rng.strip(), entry_pos, "empty layer range")
            kwargs: dict = {}
            item_cursor = entry_pos + len(rng) + 1
            for item in settings.split("+"):
                item_pos = item_cursor + len(item) - len(item.lstrip())
                item_cursor += len(item) + 1
                item = item.strip()
                if not item:
                    continue
                if item == "off":
                    kwargs["enabled"] = False
                elif item == "on":
                    kwargs["enabled"] = True
                else:
                    key, eq, val = item.partition("=")
                    if not eq:
                        fail(item, item_pos, "want KEY=VALUE or the off/on flag")
                    key, val = key.strip(), val.strip()
                    if key == "keep":
                        kwargs["keep"] = int(val)
                    elif key == "bits":
                        kwargs["bits"] = int(val)
                    elif key == "codec":
                        kwargs["codec"] = val
                    else:
                        fail(item, item_pos,
                             "unknown plan setting (keep/bits/codec/off/on)")
            rules.append((start, stop, LayerPolicy(**kwargs)))
        if not rules:
            raise ValueError(f"empty plan spec {spec!r}")
        return cls(rules=tuple(rules))

    def to_spec(self) -> str:
        """Inverse of `from_spec` (defaults omitted, roundtrip-exact)."""
        parts = []
        for start, stop, p in self.rules:
            if stop is None:
                rng = f"{start}-"
            elif stop == start + 1:
                rng = str(start)
            else:
                rng = f"{start}-{stop - 1}"
            settings = [f"keep={p.keep}"]
            if p.bits != 8:
                settings.append(f"bits={p.bits}")
            if p.codec != "dct":
                settings.append(f"codec={p.codec}")
            if not p.enabled:
                settings.append("off")
            parts.append(f"{rng}:{'+'.join(settings)}")
        return ",".join(parts)

    @staticmethod
    def _layer_bytes_per_token(cfg, pol: LayerPolicy) -> float:
        from repro_torch.codec import families as families_lib

        hd = cfg.resolved_head_dim
        assert hd % BLOCK == 0, hd
        fam = families_lib.get_family(pol.codec)
        return 2 * cfg.n_kv_heads * (hd // BLOCK) * \
            fam.analytic_tile_bytes(pol.kv_keep) / BLOCK

    def kv_bytes_per_token(self, cfg) -> float:
        """Compressed KV bytes per token summed over layers (K and V,
        headers included)."""
        return sum(self._layer_bytes_per_token(cfg, pol)
                   for pol in self.policies(cfg.n_layers))

    def page_bytes(self, cfg) -> int:
        """Bytes of one paged-pool page: one 8-token block group across
        every layer."""
        return int(round(self.kv_bytes_per_token(cfg) * BLOCK))


def as_plan(value, *, keep: int | None = None,
            codec: str | None = None) -> CompressionPlan:
    """CompressionPlan | spec string | int keep | None (uniform `keep`) ->
    CompressionPlan; `codec` overrides the family on every policy."""
    if value is None:
        plan = CompressionPlan.uniform(4 if keep is None else keep)
    elif isinstance(value, CompressionPlan):
        plan = value
    elif isinstance(value, str):
        plan = CompressionPlan.from_spec(value)
    elif isinstance(value, int):
        plan = CompressionPlan.uniform(value)
    else:
        raise TypeError(f"cannot interpret {value!r} as a CompressionPlan")
    if codec is None:
        return plan
    from dataclasses import replace

    return CompressionPlan(
        rules=tuple((s, e, replace(p, codec=codec)) for s, e, p in plan.rules),
        default=replace(plan.default, codec=codec))
