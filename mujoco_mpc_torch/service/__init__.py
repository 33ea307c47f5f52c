"""The gRPC services and clients (agent, state estimation, direct
optimizer) over the port's Agent, estimators and Direct, on the JAX
package's wire (its .proto files and generated modules, copied)."""
