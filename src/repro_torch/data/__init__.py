from repro_torch.data.pipeline import FileStream, SyntheticStream, make_stream

__all__ = ["FileStream", "SyntheticStream", "make_stream"]
