"""The wire layer of the port: frames byte-compatible with the JAX
package's ``netps`` protocol, its typed errors and the endpoint walker.
The parameter server itself comes with the training slices."""
