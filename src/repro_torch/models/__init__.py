"""The dense decoder: layers, transformer assembly and the model API."""
