// Native smoke test: drive the port's agent from C++ through the C ABI
// (the reference's embedding use case, mjpc/interface.h:43-48).
//
// Usage: capi_smoke TASK TERM DEVICE GAP_MS NV QPOS...
//   TERM a cost term whose weight it sets, DEVICE "-" for the default (the
//   card) or "cpu", GAP_MS the gap between the two calls below (longer
//   than a plan), NV the task's nv, then the task's qpos. qvel is zero.
//
// It checks every return code, printing the library's error text on a
// failure, and asks two actions at the same state and time GAP_MS apart
// with no call between them: they differ only if the plan thread ran
// meanwhile, which it cannot while the host holds the GIL. On a loaded
// host a plan may outlast the gap, so the pair is asked again, up to
// kRounds times; while the host held the GIL, a call would let the plan
// thread run for a switch interval at most, far less than a plan.

#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int mjpc_create_policy(const char* task, const char* planner,
                       const char* device);
int mjpc_step_policy(int handle, const double* qpos, int nq,
                     const double* qvel, int nv, double time,
                     double* action, int nu_cap);
int mjpc_set_weight(int handle, const char* term, double weight);
int mjpc_destroy_policy(int handle);
const char* mjpc_last_error();
}

static int Fail(const char* what) {
  std::fprintf(stderr, "capi_smoke: %s failed: %s\n", what,
               mjpc_last_error());
  return 1;
}

int main(int argc, char** argv) {
  if (argc < 7) {
    std::fprintf(stderr,
                 "usage: capi_smoke TASK TERM DEVICE GAP_MS NV QPOS...\n");
    return 2;
  }
  const char* task = argv[1];
  const char* term = argv[2];
  const char* device = std::string(argv[3]) == "-" ? nullptr : argv[3];
  int gap_ms = std::atoi(argv[4]);
  int nv = std::atoi(argv[5]);
  std::vector<double> qpos;
  for (int i = 6; i < argc; ++i) qpos.push_back(std::atof(argv[i]));
  std::vector<double> qvel(nv, 0.0);
  int nq = static_cast<int>(qpos.size());

  int h = mjpc_create_policy(task, "sampling", device);
  if (h < 0) return Fail("create_policy");
  const int cap = 64, kRounds = 5;
  double first[cap] = {0}, second[cap] = {0}, action0 = 0.0, diff = 0.0;
  int nu = -1, pair = 0;
  while (diff == 0.0 && pair < kRounds) {
    ++pair;
    nu = mjpc_step_policy(h, qpos.data(), nq, qvel.data(), nv, 0.0, first,
                          cap);
    if (nu < 0) return Fail("step_policy");
    for (int i = 0; i < nu; ++i) {
      if (!std::isfinite(first[i])) {
        std::fprintf(stderr, "capi_smoke: action[%d] = %f\n", i, first[i]);
        return 1;
      }
    }
    if (pair == 1) action0 = first[0];
    // the same state and time after GAP_MS in which the host makes no call
    std::this_thread::sleep_for(std::chrono::milliseconds(gap_ms));
    if (mjpc_step_policy(h, qpos.data(), nq, qvel.data(), nv, 0.0, second,
                         cap) != nu) {
      return Fail("step_policy (second)");
    }
    for (int i = 0; i < nu; ++i) {
      diff = std::fmax(diff, std::fabs(first[i] - second[i]));
    }
  }
  if (mjpc_set_weight(h, term, 0.2) != 0) return Fail("set_weight");
  if (mjpc_destroy_policy(h) != 0) return Fail("destroy_policy");
  std::printf("same state %d ms apart: max |action change| %g (pair %d of "
              "at most %d)\n", gap_ms, diff, pair, kRounds);
  if (diff == 0.0) {
    std::fprintf(stderr, "capi_smoke: the two actions of each of %d pairs "
                 "are equal: the plan thread did not run between the "
                 "calls\n", kRounds);
    return 1;
  }
  std::printf("C ABI smoke test OK: nu=%d action[0]=%f\n", nu, action0);
  return 0;
}
