"""The port's copies of the repo's research projects (the root ``projects``
package imports the JAX package; these import torch only)."""
