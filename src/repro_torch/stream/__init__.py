from repro_torch.stream.stream import EdgeStream, StreamConfig, build_stream
