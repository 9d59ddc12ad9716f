"""Models: ResNet family, SimCLR, MIL, CNN encoder, UNet, int8, weight conversion.

The names of the JAX package's ``models`` resolve here at first use."""

from ss25_hierarchical_multiscale_image_classification_tpu_torch._exports import (
    lazy_exports,
)

__getattr__, __dir__ = lazy_exports(__name__, {
    "ResNet": "resnet",
    "ResNet18Classifier": "resnet",
    "ResNet18FeatureExtractor": "resnet",
    "ResNet50": "resnet",
    "UnifiedResNet": "resnet",
    "SimCLRModel": "simclr",
    "nt_xent_loss": "simclr",
    "MILAttentionPooling": "mil",
    "MILClassifier": "mil",
    "CNNEncoder": "cnn_encoder",
    "UNet": "unet",
    "UNetClassifier": "unet",
    "QuantizedResNet18": "quantized",
    "quantize_resnet18": "quantized",
})
