"""The port's input pipeline: the device frame cache and the batched
preprocessing on the device."""
