"""api/tpu_codec.decode_batch_sharded: one batch a call, entropy-decoded on
the host (num_threads threads), its batch axis split over a mesh of every
card the cell asks for, each card's share rendered and read back."""


def start(devices, traffic):
    from libjxl_tpu_torch.api import tpu_codec
    from libjxl_tpu_torch.parallel.sharding import make_mesh

    return tpu_codec, make_mesh(devices), dict(traffic["args"])


def call(handle, streams):
    tpu_codec, mesh, args = handle
    return tpu_codec.decode_batch_sharded(streams, mesh=mesh, **args), None
