"""Zamba2-7B-Instruct at its published config (hf: Zyphra/Zamba2-7B-Instruct,
config.json): 81 Mamba2 layers with 2 groups, and two shared attention +
MLP blocks applied in turn at 13 hybrid positions [arXiv:2411.15242].

The shared block reads ``concat(x, embedding)`` (7168 wide: 32 heads of
224), scales its softmax by ``(224 / 2) ** -0.5``, has no residual inside,
adds a rank-128 LoRA of its application to the MLP's gate and up
projections, and its output, through a linear of the application, is added
to the next Mamba2 mixer's input.  The head is tied to the embedding, which
is not scaled.

The fields the published model adds live on :class:`Zamba2Config`, a
frozen subclass of ``ArchConfig``: the registry's ``ArchConfig`` and
``ARCH_IDS`` stay field for field those of the JAX package, and
``get_config("zamba2_7b")`` reaches this module by name.
"""

import dataclasses

from repro_torch.configs.common import ArchConfig


@dataclasses.dataclass(frozen=True)
class Zamba2Config(ArchConfig):
    # the layers whose Mamba2 mixer reads a shared block's output (the
    # published ``layers_block_type``'s "hybrid" entries); application k
    # runs shared block ``k % n_mem_blocks`` with its own LoRA and linear
    hybrid_layer_ids: tuple[int, ...] = ()
    n_mem_blocks: int = 2
    ssm_ngroups: int = 1          # B and C groups; head j reads j // (H/G)
    adapter_rank: int = 128       # the MLP LoRA of each application

    @property
    def attn_in(self) -> int:
        """The shared block's input width: ``concat(x, embedding)``."""
        return 2 * self.d_model

    @property
    def n_apps(self) -> int:
        return len(self.hybrid_layer_ids)

    def block_of(self, app: int) -> int:
        return app % self.n_mem_blocks


CONFIG = Zamba2Config(
    name="zamba2-7b-instruct", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=224,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    ssm_chunk=256, ssm_ngroups=2,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    n_mem_blocks=2, adapter_rank=128,
    rope_theta=10000.0, norm_eps=1e-5,
)

# 9 layers, hybrids at uneven gaps: block 0 runs twice (applications 0
# and 2) with different adapters
SMOKE = dataclasses.replace(
    CONFIG, n_layers=9, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    hybrid_layer_ids=(2, 5, 7), adapter_rank=8)
