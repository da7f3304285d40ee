"""Hand-written CUDA kernels of the port and their launch counters.

``csrc/*.cu`` hold the kernels, ``_build.py`` builds and loads them at
first use, and each sub-package has the three files of its counterpart in
the reference: the kernel's binding (``paged_attention.py`` /
``page_pack.py``), the model-facing wrapper (``ops.py``) and a plain
PyTorch version of the same function (``ref.py``).

``LAUNCHES`` counts kernel launches: a binding adds one exactly where it
launches its kernel and nowhere else, so a run can show that it really
went through the kernels.
"""

LAUNCHES = {"paged_attention": 0, "page_gather": 0, "page_scatter": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)
