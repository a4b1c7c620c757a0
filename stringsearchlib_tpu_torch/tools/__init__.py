"""Probe tools of the PyTorch port: the reference's K1 probes (tools/
probe_bandwidth.py, probe_layout_r5.py, probe_kernel_raw.py,
probe_kernel_bisect.py) on the CUDA card, through ``ops.probes``.

Run each from the repository root on a machine with a card, e.g.
``python3 -m stringsearchlib_tpu_torch.tools.probe_layout``; each raises
without one.  Nothing here runs when the package is imported.
"""
