"""Port models: ResNet18 in torchvision layout, and weight conversion."""
