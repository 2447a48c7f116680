"""PyTorch-module bindings of the port: ``bindings.torch_interop`` holds
tiny-cuda-nn's ``NetworkWithInputEncoding``, ``Network`` and ``Encoding``
modules (the counterpart of ``tcnn_tpu/bindings/``)."""
