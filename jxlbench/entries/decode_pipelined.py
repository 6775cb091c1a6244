"""api/tpu_codec.decode_pipelined: a list of streams a call, entropy-decoded
on the host in batches of traffic["args"]["batch_size"] (native C with
num_threads threads) while the card renders the batch before."""


def start(devices, traffic):
    from libjxl_tpu_torch.api import tpu_codec

    return tpu_codec, devices[0], dict(traffic["args"])


def call(handle, streams):
    tpu_codec, dev, args = handle
    return tpu_codec.decode_pipelined(streams, device=dev, **args), None
