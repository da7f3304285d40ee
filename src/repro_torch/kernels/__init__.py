"""Hand-written CUDA kernels of the port and their launch counters.

``csrc/*.cu`` hold the kernels, ``_build.py`` builds and loads them at
first use, and each sub-package has the three files of its counterpart in
the reference: the kernel's binding (``paged_attention.py`` /
``page_pack.py`` / ``flash_attention.py``), the model-facing wrapper
(``ops.py``) and a plain PyTorch version of the same function (``ref.py``).

``LAUNCHES`` counts kernel launches: a binding adds one exactly where it
launches its kernel and nowhere else, so a run can show that it really
went through the kernels.  ``flash_attention_bwd`` counts one per backward
call (its three kernels launch together).

A kernel takes one rank's local tensors: :func:`require_local` is each
``ops.py`` wrapper's guard against a DTensor, on any device (the model's
regions hand the wrappers ``.to_local()`` shards).
"""

LAUNCHES = {"paged_attention": 0, "page_gather": 0, "page_scatter": 0,
            "flash_attention": 0, "flash_attention_bwd": 0}
#: launches of a kernel that is one route of a binding counted above: the
#: decode kernel of few-row flash forwards (``csrc/flash_decode.cu``), the
#: bf16 forward of the other calls (``csrc/flash_attention_wgmma.cu``) and
#: the f32 forward of theirs (``csrc/flash_attention.cu``) each count one
#: under ``LAUNCHES["flash_attention"]`` and one here; the f32 backward one
#: under ``LAUNCHES["flash_attention_bwd"]`` and one here
ROUTE_LAUNCHES = {"flash_decode": 0, "flash_wgmma_fwd": 0,
                  "flash_f32_fwd": 0, "flash_f32_bwd": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, ROUTE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def route_launch_counts() -> dict:
    return dict(ROUTE_LAUNCHES)


def require_local(*tensors) -> None:
    """Raise ``TypeError`` for a DTensor among ``tensors``."""
    from torch.distributed.tensor import DTensor
    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(
                "a kernel wrapper takes local tensors, not a DTensor "
                f"({tuple(t.placements)} on {t.device_mesh}); call it from "
                "a region that passes .to_local() shards")
