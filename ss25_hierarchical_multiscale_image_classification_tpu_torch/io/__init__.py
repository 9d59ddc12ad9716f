"""Host I/O: slide readers, annotations, downloads, synthetic slides.

The names of the JAX package's ``io`` resolve here at first use."""

from ss25_hierarchical_multiscale_image_classification_tpu_torch._exports import (
    lazy_exports,
)

__getattr__, __dir__ = lazy_exports(__name__, {
    "parse_annotation_xml": "annotations",
    "write_annotation_xml": "annotations",
    "ArraySlide": "slide",
    "Slide": "slide",
    "open_slide": "slide",
    "SyntheticSlideSpec": "synthetic",
    "make_synthetic_slide": "synthetic",
    "write_synthetic_case": "synthetic",
})
