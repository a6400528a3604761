// pyp_tpu_torch launcher — host-side entry binary.
//
// C++ reimplementation of the role the reference's Rust launcher plays
// (launcher/src/main.rs: read user config, wrap argv,
// re-exec the Python driver inside the runtime environment). Behavior:
//
//   1. determine the mode from argv[0] (symlink farm: `spr`, `tomo`, `csp`,
//      `fyp` -> refine, `byp` -> params — mirroring the reference's 9-line
//      bash wrappers bin/csp etc.), or from the first argument;
//   2. read ~/.pyp_tpu/config.toml (key = value lines) for `python`,
//      `pyp_path`, and extra environment entries;
//   3. exec `python -m pyp_tpu_torch.cli <mode> <args...>` with PYTHONPATH set.
//
// Build: pyp_tpu_torch.ops._build.build_executable("launcher")  ->  _build/launcher-<hash>

#include <cstdlib>
#include <cstring>
#include <fstream>
#include <iostream>
#include <map>
#include <sstream>
#include <string>
#include <unistd.h>
#include <vector>

static std::string basename_of(const std::string& path) {
    auto pos = path.find_last_of('/');
    return pos == std::string::npos ? path : path.substr(pos + 1);
}

static std::map<std::string, std::string> read_config() {
    std::map<std::string, std::string> cfg;
    const char* home = std::getenv("HOME");
    if (!home) return cfg;
    std::ifstream f(std::string(home) + "/.pyp_tpu/config.toml");
    std::string line;
    while (std::getline(f, line)) {
        auto hash = line.find('#');
        if (hash != std::string::npos) line = line.substr(0, hash);
        auto eq = line.find('=');
        if (eq == std::string::npos) continue;
        auto trim = [](std::string s) {
            size_t a = s.find_first_not_of(" \t\"");
            size_t b = s.find_last_not_of(" \t\"");
            return a == std::string::npos ? std::string() : s.substr(a, b - a + 1);
        };
        cfg[trim(line.substr(0, eq))] = trim(line.substr(eq + 1));
    }
    return cfg;
}

int main(int argc, char** argv) {
    std::string prog = basename_of(argv[0]);
    // argv[0]-based mode dispatch matching the reference's bin/run farm
    // (bin/run/{fyp,byp,pcl,pex,pmk,psp,gyp,rlp,sva,3davg,streampyp}: each
    // wrapper exports one env mode for bin/run/pyp — here an alias maps
    // straight to the equivalent CLI subcommand)
    std::map<std::string, std::string> aliases = {
        {"spr", "spr"},       {"tomo", "tomo"},
        {"csp", "csp"},       {"fyp", "refine"},
        {"byp", "byp"},       {"pcl", "clean"},
        {"pex", "export_session"}, {"ppp", "postprocess"},
        {"pmk", "mask"},      {"psp", "postprocess"},
        {"gyp", "gain"},      {"rlp", "import_star"},
        {"rln", "export_star"}, {"wrp", "import_star"},
        {"sva", "sva"},       {"3davg", "sva"},
        {"streampyp", "stream"},
    };
    std::vector<std::string> args;
    auto alias = aliases.find(prog);
    if (alias != aliases.end()) {
        args.push_back(alias->second);
    }
    for (int i = 1; i < argc; i++) args.push_back(argv[i]);

    auto cfg = read_config();
    std::string python = cfg.count("python") ? cfg["python"] : "python3";
    if (const char* env_py = std::getenv("PYP_TPU_PYTHON")) python = env_py;

    std::string pyp_path = cfg.count("pyp_path") ? cfg["pyp_path"] : "";
    if (const char* env_path = std::getenv("PYP_TPU_PATH")) pyp_path = env_path;
    if (!pyp_path.empty()) {
        const char* old = std::getenv("PYTHONPATH");
        std::string merged = old ? pyp_path + ":" + old : pyp_path;
        setenv("PYTHONPATH", merged.c_str(), 1);
    }
    // forward any config keys of the form env_NAME as environment variables
    for (const auto& [k, v] : cfg) {
        if (k.rfind("env_", 0) == 0) setenv(k.substr(4).c_str(), v.c_str(), 1);
    }

    std::vector<char*> execv_args;
    execv_args.push_back(const_cast<char*>(python.c_str()));
    execv_args.push_back(const_cast<char*>("-m"));
    execv_args.push_back(const_cast<char*>("pyp_tpu_torch.cli"));
    for (auto& a : args) execv_args.push_back(const_cast<char*>(a.c_str()));
    execv_args.push_back(nullptr);

    execvp(python.c_str(), execv_args.data());
    std::cerr << "pyp_tpu_torch launcher: failed to exec " << python << ": "
              << std::strerror(errno) << "\n";
    return 127;
}
