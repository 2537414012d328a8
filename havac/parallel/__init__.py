from havac.parallel.wavefront import make_wavefront_fn, ssv_wavefront

__all__ = ["make_wavefront_fn", "ssv_wavefront"]
