"""Hardware context (paper Appendix C): the typed ``HardwareContext`` the
cost model and the search read, extracted from the mesh plus the target
chip's constants.

Port copy of ``repro/core/hardware.py``. The field names stay those the
cost models read (``ici_link_bw`` is the per-direction peer link whatever
the fabric), so the workloads' ``cost_breakdown`` copies stay line for
line; :data:`H100` adds the card the port runs on.
"""
from __future__ import annotations

import functools
import subprocess
from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str = "tpu-v5e"
    peak_bf16_flops: float = 197e12          # FLOP/s per chip
    hbm_bw: float = 819e9                    # B/s per chip
    ici_link_bw: float = 50e9                # B/s per ICI link (one direction)
    ici_links_per_axis: int = 2              # bidirectional ring per torus axis
    dcn_bw: float = 25e9                     # B/s per host, cross-pod
    hbm_bytes: int = 16 * 2**30
    vmem_bytes: int = 128 * 2**20


V5E = ChipSpec()

# NVIDIA H100 SXM, from NVIDIA's data sheet and the Hopper architecture
# white paper: dense bf16 tensor-core rate, HBM3 rate, NVLink 4 (900 GB/s
# per card, 450 GB/s each way, all to all through NVSwitch), 80 GiB HBM.
# ``vmem_bytes`` is the shared memory one block can use; ``dcn_bw`` is one
# 400 Gb/s NDR InfiniBand port per card.
H100 = ChipSpec(name="h100-sxm", peak_bf16_flops=989e12, hbm_bw=3.35e12,
                ici_link_bw=450e9, ici_links_per_axis=1, dcn_bw=50e9,
                hbm_bytes=80 * 2**30, vmem_bytes=232_448)


@dataclass(frozen=True)
class HardwareContext:
    chip: ChipSpec
    mesh_shape: tuple                        # e.g. (4,)
    mesh_axes: tuple                         # e.g. ("x",)
    chips_per_pod: int
    n_chips: int
    has_dcn: bool
    device_name: str = ""                    # torch.cuda.get_device_name
    sm_count: int = 0                        # multiprocessors on the card

    @property
    def fingerprint(self) -> str:
        """Stable identity of the deployment target — the hardware half of
        the warm-start eval-cache key (docs/search.md): a cached score is
        only reusable on the chip/mesh it was modeled for."""
        shape = "x".join(str(s) for s in self.mesh_shape)
        return (f"{self.chip.name}|mesh={shape}"
                f"|axes={','.join(self.mesh_axes)}|dcn={int(self.has_dcn)}")

    @property
    def topology_summary(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in zip(self.mesh_axes, self.mesh_shape))
        kind = "multi-pod (ICI intra-pod + DCN cross-pod)" if self.has_dcn else \
            "single-pod (ICI torus)"
        return (f"{self.chip.name} mesh [{axes}] — {self.n_chips} chips, {kind}; "
                f"{self.chip.peak_bf16_flops/1e12:.0f} TFLOP/s bf16, "
                f"{self.chip.hbm_bw/1e9:.0f} GB/s HBM, "
                f"{self.chip.ici_link_bw/1e9:.0f} GB/s/link ICI")


def extract_hardware_context(mesh, chip: ChipSpec = H100) -> HardwareContext:
    """The context of a :class:`~repro_torch.dist.mesh.VirtualMesh`: its
    rank axes, plus the card's name and multiprocessor count when the mesh
    lives on a CUDA device."""
    shape = tuple(mesh.shape[a] for a in mesh.axis_names)
    axes = tuple(mesh.axis_names)
    has_dcn = "pod" in axes and mesh.shape["pod"] > 1
    n = 1
    for s in shape:
        n *= s
    per_pod = n // (mesh.shape["pod"] if has_dcn else 1)
    name, sms = "", 0
    if mesh.device.type == "cuda":
        import torch
        props = torch.cuda.get_device_properties(mesh.device)
        name, sms = props.name, int(props.multi_processor_count)
    return HardwareContext(chip=chip, mesh_shape=shape, mesh_axes=axes,
                           chips_per_pod=per_pod, n_chips=n, has_dcn=has_dcn,
                           device_name=name, sm_count=sms)


@functools.lru_cache(maxsize=None)
def _smi():
    return "; ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines())


def card_label(device):
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (the label every
    number measured on the card is printed beside); off the card, the
    device's type."""
    import torch
    device = torch.device(device)
    return _smi() if device.type == "cuda" else device.type
